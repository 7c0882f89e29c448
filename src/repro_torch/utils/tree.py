"""Nested-dict parameter trees (counterpart of ``repro/utils/tree.py``).

Trees are nested dicts whose leaves are tensors or other non-dict objects
(e.g. ``CompressedTensor``).  Leaf names are the '/'-joined key paths the
JAX package uses (``body/sb_0/attn/wq``), so the two trees line up name for
name.

State trees (``TrainState``, ``StepState``, ...) are NamedTuples of such
trees and scalars.  :func:`tree_flatten_named`/:func:`tree_leaves` walk them in the
order and with the names of ``jax.tree_util``: dict keys sorted, NamedTuple
fields by name and in field order, ``None`` holding no leaf.  A train
state's moment of ``wq`` is therefore named ``opt/m/body/sb_0/attn/wq`` in
both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import torch


def tree_items(tree: dict, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(name, leaf)`` for every leaf, in insertion order."""
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from tree_items(v, name)
        else:
            yield name, v


def tree_map_with_name(fn: Callable[[str, Any], Any], tree: dict,
                       prefix: str = "") -> dict:
    """A tree of ``fn(name, leaf)`` with ``tree``'s structure."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        out[k] = (
            tree_map_with_name(fn, v, name) if isinstance(v, dict) else fn(name, v)
        )
    return out


def unflatten(flat: dict[str, Any]) -> dict:
    """Nested dict from ``{"a/b/c": leaf}``."""
    out: dict = {}
    for name, leaf in flat.items():
        node = out
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten_named(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(name, leaf)`` pairs in ``jax.tree_util`` order and naming."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(tree_flatten_named(v, f"{prefix}/{k}" if prefix else k))
    return out


def tree_leaves(tree: Any) -> list[Any]:
    """Every leaf, in ``jax.tree_util`` order."""
    return [leaf for _, leaf in tree_flatten_named(tree)]


def tree_unflatten_like(like: Any, leaves: Callable[[str, Any], Any],
                        prefix: str = "") -> Any:
    """A tree with ``like``'s structure whose leaf at ``name`` is
    ``leaves(name, like_leaf)``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: tree_unflatten_like(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(
            tree_unflatten_like(v, leaves, f"{prefix}/{f}" if prefix else f)
            for f, v in zip(like._fields, like)))
    return leaves(prefix, like)


def global_norm(tree: Any) -> torch.Tensor:
    """L2 norm over all leaves, in f32, as a 0-d tensor (no host sync)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(x.float().square().sum() for x in leaves))
