"""Placements of serving trees: ``CompressedTensor`` leaves and the paged
cache (counterpart of ``repro/distributed/compressed_pspecs.py``).

1. **Compressed weights.**  A compressed leaf's placement derives from the
   dense rule of the same name (``sharding.param_pspec``, FSDP off): tensor
   parallelism lands on the output dim, and stays on the compressed
   (reduction) dim only when the dense reduction dim divides by ``M ×
   axis size``, so a shard owns whole N:M groups.  Leaves whose output dim
   reshapes into heads shard it only in whole heads; every placement is
   sanitized against the stored shapes.
2. **Serving caches.**  A slab cache takes ``sharding.cache_pspecs``
   (each lane's sequence axis over ``model``).  Each layer's pool shards
   its *pages* axis over ``model`` (``kv_shard="seq"``), int8 ``*_scale``
   planes with their pages; page tables and lane lengths are replicated,
   so every shard resolves logical -> physical addresses itself.

:func:`shard_serving_params` applies the placements: one rank takes its
slice of every sharded compressed leaf (``CompressedTensor.rshards`` or
``oshards`` says which dim) and of the vocab-sharded token embedding, and
holds every other leaf whole (the reference spreads small dense leaves
too; here they stay replicated, ROADMAP.md §3).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from repro_torch.core.sparsity_config import _EXCLUDE_FRAGMENTS
from repro_torch.distributed.sharding import (
    MODEL_AXIS,
    _dp,
    axis_sizes,
    cache_pspecs,
    param_pspec,
    sanitize_spec,
)
from repro_torch.sparse_infer.compress import CompressedTensor
from repro_torch.utils.tree import tree_map_with_name


def _axis_size(entry, mesh) -> int:
    """Total device count behind one placement entry (axis name or tuple)."""
    sizes = axis_sizes(mesh)
    k = 1
    for a in entry if isinstance(entry, tuple) else (entry,):
        k *= sizes.get(a, 1)
    return k


def _names(entries) -> set:
    return {a for e in entries if e is not None for a in (e if isinstance(e, tuple) else (e,))}


# leaves whose output dim reshapes to (heads, head_dim) and is then sliced
# (RoPE halves, MLA's nope/rope/v splits): TP on that dim owns whole heads
_HEAD_GATED = (
    (re.compile(r"attn/(wq|bias_q|w_q)$"), lambda cfg: cfg.n_heads),
    (re.compile(r"attn/(wk|wv|bias_k|bias_v)$"), lambda cfg: cfg.n_kv),
    (re.compile(r"attn/w_ukv$"), lambda cfg: cfg.n_heads),
)
# outputs that downstream code slices apart: never TP the packed dim
_SLICED_OUT = re.compile(r"mixer/(w_in|conv_w)$")
# MoE expert stacks serve reduction-dim TP'd (the reference's choice)
_EP_STACKS = re.compile(r"moe/w_(gate|up|down)_e$")


def _out_dim_ok(name: str, cfg, entry, mesh) -> bool:
    """May ``entry`` shard this leaf's output dim?  (Head/concat gates.)"""
    if cfg is None:
        return True
    if _SLICED_OUT.search(name):
        return False
    for rx, heads in _HEAD_GATED:
        if rx.search(name):
            return heads(cfg) % _axis_size(entry, mesh) == 0
    return True


def _serving_entries(name: str, ndim: int, mesh, cfg) -> list:
    """The dense rule's entries, moved off head and packed-concat structure
    to the reduction dim, and a reduction-dim TP for matmul weights the
    rules leave whole (the reference's ``_serving_entries``)."""
    entries = list(param_pspec(name, ndim))
    if cfg is None or ndim < 1:
        return entries
    if _EP_STACKS.search(name) and ndim >= 2:
        entries = [None] * ndim
        entries[-2] = MODEL_AXIS
        return entries
    is_bias = "bias" in name
    if entries[-1] is not None and not _out_dim_ok(name, cfg, entries[-1], mesh):
        ent, entries[-1] = entries[-1], None
        if not is_bias and ndim >= 2 and entries[-2] is None:
            entries[-2] = ent  # reduction-dim TP
    if (not is_bias and ndim >= 2 and MODEL_AXIS not in _names(entries)
            and not _SLICED_OUT.search(name) and entries[-2] is None
            and not any(f in name.lower() for f in _EXCLUDE_FRAGMENTS)):
        entries[-2] = MODEL_AXIS
    return entries


def compressed_pspec(name: str, ct: CompressedTensor, mesh, *, cfg=None) -> tuple:
    """``(values placement, indices placement)`` of one compressed leaf: the
    serving entries at the stored rank, the group axis kept only when whole
    groups land on every shard (else moved to a free output dim), both
    sanitized against the stored shapes."""
    v_shape = tuple(ct.values.shape)
    ndim = len(v_shape)
    entries = _serving_entries(name, ndim, mesh, cfg)
    gaxis = ndim - 2
    entry = entries[gaxis]
    if entry is not None:
        k = _axis_size(entry, mesh)
        dense_in = v_shape[gaxis] * ct.m // max(ct.n, 1)
        if k <= 0 or dense_in % (ct.m * k) != 0:
            entries[gaxis] = None
            if entries[-1] is None and _out_dim_ok(name, cfg, entry, mesh):
                entries[-1] = entry
    return (sanitize_spec(tuple(entries), v_shape, mesh),
            sanitize_spec(tuple(entries), tuple(ct.indices.shape), mesh))


def serving_param_pspecs(params: dict, mesh, *, cfg=None) -> dict:
    """The placement of every leaf of a serving tree: a compressed leaf's is
    the pair of :func:`compressed_pspec`."""

    def leaf(name, x):
        if isinstance(x, CompressedTensor):
            return compressed_pspec(name, x, mesh, cfg=cfg)
        entries = _serving_entries(name, x.dim(), mesh, cfg)
        return sanitize_spec(tuple(entries), tuple(x.shape), mesh)

    return tree_map_with_name(leaf, params)


def _model_dim(spec: tuple, mesh) -> Optional[int]:
    """The dim a placement splits over a ``model`` axis of more than one
    device, or None."""
    if axis_sizes(mesh).get(MODEL_AXIS, 1) <= 1:
        return None
    dims = [i for i, e in enumerate(spec) if e is not None and MODEL_AXIS in _names((e,))]
    return dims[0] if dims else None


def shard_serving_params(params: dict, mesh, *, cfg=None, device=None) -> dict:
    """One rank's serving tree: its slice of every compressed leaf the
    placements shard, stamped ``rshards`` on the reduction dim (where the
    reference's ``annotate_reduction_tp`` stamps it) or ``oshards`` on the
    output dim, and of a vocab-sharded ``tok_embed``, every other leaf
    whole; each moved to ``device`` (default: the mesh's).  A one-device
    model axis returns the leaves themselves."""
    model = axis_sizes(mesh).get(MODEL_AXIS, 1)
    index = mesh.model_index
    dev = device if device is not None else mesh.device
    specs = serving_param_pspecs(params, mesh, cfg=cfg)

    def place(t):
        return t.to(dev).contiguous()

    def own(t):  # a slice in storage of its own (a view would keep the whole leaf alive)
        return torch.empty_like(t, device=dev, memory_format=torch.contiguous_format).copy_(t)

    def leaf(name, x):
        spec = _at(specs, name)
        if isinstance(x, CompressedTensor):
            dim = _model_dim(spec[0], mesh)
            if dim is None:
                return dataclasses.replace(x, values=place(x.values), indices=place(x.indices))
            if dim < x.values.dim() - 2:
                raise NotImplementedError(f"{name}: placement {spec[0]} splits neither the "
                                          "reduction nor the output dim (the rest of tensor "
                                          "parallelism, ROADMAP.md)")
            part = x.shard(dim, index, model)
            return dataclasses.replace(part, values=own(part.values), indices=own(part.indices))
        if name.endswith("tok_embed") and _model_dim(spec, mesh) == 0:
            return own(x.narrow(0, index * (x.shape[0] // model), x.shape[0] // model))
        return place(x)

    return tree_map_with_name(leaf, params)


def _at(tree: dict, name: str):
    for key in name.split("/"):
        tree = tree[key]
    return tree


def serving_cache_pspecs(mesh, cache: dict, layout, *, kv_shard: str = "seq") -> dict:
    """The placement of every leaf of a serving cache.  A slab cache is
    :func:`sharding.cache_pspecs`'s (its sequence axis on ``model``).  On
    the paged layout each pool leaf (and its int8 ``*_scale`` plane) takes
    its pages axis (``kv_shard="seq"``) or its feature axis
    (``"feature"``), page tables are replicated, lane lengths and
    recurrent states go over the data axes, SSM states their heads on
    ``model``."""
    if getattr(layout, "kind", None) != "paged":
        return cache_pspecs(mesh, cache, kv_shard=kv_shard)
    dp = _dp(mesh)

    def leaf(name, x):
        nd = x.dim()
        parts = name.split("/")
        if parts[0] == "tables":
            return (None,) * nd
        if parts[-1] == "len" or nd <= 1:
            return (dp,) + (None,) * max(0, nd - 1)
        stacked = re.search(r"(^|/)body/", name) is not None
        if stacked:
            nd -= 1
        if parts[-1].endswith("_scale"):
            spec = (MODEL_AXIS,) + (None,) * (nd - 1) if kv_shard == "seq" else (None,) * nd
        elif parts[-1] in ("k", "v", "ckv", "krope"):
            spec = ((MODEL_AXIS,) + (None,) * (nd - 1) if kv_shard == "seq"
                    else (None,) * (nd - 1) + (MODEL_AXIS,))
        elif nd == 4 and "state" in name:
            spec = (dp, MODEL_AXIS, None, None)
        else:
            spec = (dp,) + (None,) * (nd - 1)
        return (None,) + spec if stacked else spec

    return tree_map_with_name(leaf, cache)


def check_kv_shard(mesh, kv_shard: str) -> None:
    """``kv_shard="feature"`` on a model axis of more than one device raises,
    as in the reference (its feature-sharded write miscompiles there); it
    stays accepted on one device."""
    if kv_shard not in ("seq", "feature"):
        raise ValueError(f"kv_shard must be 'seq' or 'feature', got {kv_shard!r}")
    if mesh is None or kv_shard != "feature":
        return
    if axis_sizes(mesh).get(MODEL_AXIS, 1) > 1:
        raise NotImplementedError(
            'kv_shard="feature" is not supported on meshes with a model axis > 1; '
            'use kv_shard="seq" (the default)')
