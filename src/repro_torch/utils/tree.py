"""Nested-dict parameter trees (counterpart of ``repro/utils/tree.py``).

Trees are nested dicts whose leaves are tensors or other non-dict objects
(e.g. ``CompressedTensor``).  Leaf names are the '/'-joined key paths the
JAX package uses (``body/sb_0/attn/wq``), so the two trees line up name for
name.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


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
