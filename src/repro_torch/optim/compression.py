"""Error-feedback sign compression of the data-parallel gradient (counterpart
of ``repro/optim/compression.py``).

1-bit Adam (Tang et al., 2021, cited by STEP as its motivation) shows that
compressed gradient communication works for Adam only once the variance
is frozen.  STEP freezes ``v*`` at the AutoSwitch step by construction, so
in phase 2 the data-parallel average can take 1-bit sign compression with
error feedback: each rank sends ``sign(x) · mean|x|`` per leaf, ``x`` its
gradient plus the residual it kept from the last step, and keeps ``x``
minus what it sent.

The numerics are the reference's, in plain PyTorch: the average runs over
the f32 ``sign · scale`` values (``train.loop``), as the reference's
``pmean`` does; a packed 1-bit wire format would change the bytes on the
wire, not the result (:func:`compressed_bits_per_element` is the cost
model the reference's roofline reads).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils.tree import tree_map_with_name, tree_unflatten_like


class CompressionState(NamedTuple):
    """Per-leaf error-feedback residual, f32, in the gradients' structure."""

    residual: Any


def init_compression_state(grads_like: dict) -> CompressionState:
    """Zero residuals, f32, one per leaf of ``grads_like``."""
    return CompressionState(residual=tree_map_with_name(
        lambda _, g: torch.zeros_like(g, dtype=torch.float32), grads_like))


def _compress_leaf(g: torch.Tensor, r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sign(x) · mean|x|, x - that)`` for ``x = g + r`` in f32: one scale
    for the leaf as stored (a stacked ``body/`` leaf's spans every layer)."""
    x = g.float() + r
    q = torch.sign(x) * x.abs().mean()
    return q, x - q


def ef_sign_compress(grads: dict, state: CompressionState,
                     enabled: bool) -> tuple[dict, CompressionState]:
    """Compress a gradient tree with error feedback.  ``enabled`` is the
    STEP phase flag (a host bool): when False (phase 1) the gradients pass
    through as f32 and the residual stays as it is, as the reference's
    ``jnp.where`` gives."""
    if not enabled:
        return tree_map_with_name(lambda _, g: g.float(), grads), state
    out = {}

    def leaf(name, g):
        out[name] = _compress_leaf(g, _at(state.residual, name))
        return out[name][0]

    q = tree_map_with_name(leaf, grads)
    return q, CompressionState(tree_unflatten_like(state.residual, lambda n, _: out[n][1]))


def _at(tree: dict, name: str):
    for key in name.split("/"):
        tree = tree[key]
    return tree


def compressed_bits_per_element(dtype=torch.bfloat16) -> float:
    """The wire format's cost model: 1 bit an element (plus one f32 scale a
    leaf, negligible)."""
    return 1.0
