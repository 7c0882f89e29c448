"""Gradient transformations (counterpart of ``repro/optim/base.py``).

A :class:`GradientTransformation` is an ``(init, update)`` pair, as in the
reference:

    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    apply_updates(params, updates)

Trees are nested dicts keyed like the parameters.  Unlike the reference's
pure functions, ``update`` advances the state's moment tensors in place
(the returned state holds the same tensors) and :func:`apply_updates`
adds to the parameters in place: at full width that saves a copy of every
moment and parameter per step.  Updates are *added* (the transformation
negates by the learning rate).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import numpy as np
import torch

from repro_torch.utils.tree import tree_flatten_named, unflatten

Schedule = Union[float, Callable[[int], float]]


class GradientTransformation(NamedTuple):
    init: Callable[[dict], Any]
    update: Callable[..., tuple[dict, Any]]


def lr_at(schedule: Schedule, step: int) -> float:
    """The rate at ``step``, rounded to f32 as the reference's schedules
    compute it."""
    return float(np.float32(schedule(step) if callable(schedule) else schedule))


def bias_correction(beta: float, step: int) -> float:
    """``1 - beta**step`` in f32, as the reference computes it."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(step))


def leaves_by_name(*trees: dict) -> tuple[list[str], list[list[torch.Tensor]]]:
    """The leaf names of ``trees[0]`` (all trees share its structure) and,
    per tree, its leaves in that order."""
    names = [n for n, _ in tree_flatten_named(trees[0])]
    flats = [dict(tree_flatten_named(t)) for t in trees]
    return names, [[f[n] for n in names] for f in flats]


def tree_like(names: list[str], leaves: list) -> dict:
    return unflatten(dict(zip(names, leaves)))


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    """``p + u.to(p.dtype)`` in place: the update is cast to the parameter's
    type first (bf16 parameters add a bf16 update), as the reference does."""
    _, (ps, us) = leaves_by_name(params, updates)
    for p, u in zip(ps, us):
        if u is not None:
            p.add_(u.to(p.dtype))
    return params
