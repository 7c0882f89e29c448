"""Adam / AdamW / momentum SGD (counterpart of ``repro/optim/adam.py``):
the plain optimizers of paper Eq. 2-7, and the baselines the STEP
optimizer (``core/step_optimizer.py``) is held against.  Moments are f32
and advance in place; see ``optim/base.py``."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.optim.base import (
    GradientTransformation,
    Schedule,
    bias_correction,
    lr_at,
    leaves_by_name,
    tree_like,
)
from repro_torch.utils.tree import tree_flatten_named, tree_map_with_name


def zeros_f32(params: dict) -> dict:
    return tree_map_with_name(lambda _, p: torch.zeros_like(p, dtype=torch.float32), params)


class AdamState(NamedTuple):
    step: int
    m: dict  # first moment
    v: dict  # second moment ("variance" in the paper)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """Adam's moments and bias correction; the update is the direction
    ``m̂/(√v̂+ε)``."""

    def init(params):
        return AdamState(step=0, m=zeros_f32(params), v=zeros_f32(params))

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state.step + 1
        bc1, bc2 = bias_correction(b1, step), bias_correction(b2, step)
        names, (gs, ms, vs) = leaves_by_name(grads, state.m, state.v)
        out = []
        for g, mm, vv in zip(gs, ms, vs):
            g = g.float()
            mm.mul_(b1).add_((1 - b1) * g)
            vv.mul_(b2).add_((1 - b2) * g.square())
            out.append((mm / bc1) / (torch.sqrt(vv / bc2) + eps))
        return tree_like(names, out), AdamState(step=step, m=state.m, v=state.v)

    return GradientTransformation(init, update)


def adam(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    return adamw(learning_rate, b1, b2, eps)


def adamw(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          mask: Optional[Callable[[dict], dict]] = None) -> GradientTransformation:
    """Adam with decoupled weight decay; ``mask(params)`` is a tree of bools
    selecting the decayed leaves (default: all)."""
    inner = scale_by_adam(b1, b2, eps)

    @torch.no_grad()
    def update(grads, state, params=None):
        updates, state = inner.update(grads, state, params)
        lr = lr_at(learning_rate, state.step)
        names, (us,) = leaves_by_name(updates)
        if weight_decay and params is not None:
            decayed = dict(tree_flatten_named(mask(params))) if mask else {}
            _, (ps,) = leaves_by_name(params)
            us = [u + weight_decay * p.float() if decayed.get(n, True) else u
                  for n, u, p in zip(names, us, ps)]
        return tree_like(names, [u.mul_(-lr) for u in us]), state

    return GradientTransformation(inner.init, update)


class SgdState(NamedTuple):
    step: int
    momentum: dict


def sgd(learning_rate: Schedule, momentum: float = 0.9,
        nesterov: bool = False) -> GradientTransformation:
    """Momentum SGD, the optimizer SR-STE was tuned for."""

    def init(params):
        return SgdState(step=0, momentum=zeros_f32(params))

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state.step + 1
        lr = lr_at(learning_rate, step)
        names, (gs, bs) = leaves_by_name(grads, state.momentum)
        out = []
        for g, buf in zip(gs, bs):
            g = g.float()
            buf.mul_(momentum).add_(g)
            d = g + momentum * buf if nesterov else buf.clone()
            out.append(d.mul_(-lr))
        return tree_like(names, out), SgdState(step=step, momentum=state.momentum)

    return GradientTransformation(init, update)
