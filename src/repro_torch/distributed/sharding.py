"""Sharding rules: parameter names -> placements (counterpart of
``repro/distributed/sharding.py``).

A placement is a tuple with one entry per dim of the leaf: ``None``
(replicated along that dim) or a mesh axis name (or a tuple of names), the
contents of the reference's ``PartitionSpec`` as plain Python data.  The
rules are the reference's Megatron-style tensor parallelism on the
``model`` axis: q/k/v, gate/up and fc column-sharded, o, down and proj
row-sharded, embeddings vocab-sharded.  They are the serving rules, with
FSDP off (decode reads every weight each step); training's FSDP
placements and ``state_pspecs`` are not ported (the rest of tensor
parallelism, ROADMAP.md).  :func:`cache_pspecs` places a slab cache.

A mesh here is anything with ``axis_names`` and a ``devices`` array of
the mesh's shape: ``launch.mesh.Mesh`` or a stand-in.
"""
from __future__ import annotations

import re

from repro_torch.utils.tree import tree_map_with_name

MODEL_AXIS = "model"
DP_AXES = ("pod", "data")  # pod omitted automatically on single-pod meshes

Placement = tuple


def axis_sizes(mesh) -> dict:
    """Axis name -> size."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _dp(mesh):
    axes = tuple(a for a in DP_AXES if a in mesh.axis_names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


# (regex over the leaf name, placement) — first match wins.  Placements are
# written for the *unstacked* rank; a leading None is prepended for "body/"
# leaves.  The reference's FSDP entries (``data`` on the feature dims) are
# off: serving reads every weight each decode step.
_RULES = [
    # embeddings: vocab on model
    (r"tok_embed$", (MODEL_AXIS, None)),
    (r"out_embed$", (None, MODEL_AXIS)),
    (r"frontend_proj$", (None, None)),
    # attention
    (r"attn/w(q|k|v)$", (None, MODEL_AXIS)),
    (r"attn/wo$", (MODEL_AXIS, None)),
    (r"attn/bias_(q|k|v)$", (MODEL_AXIS,)),
    (r"attn/bias_o$", (None,)),
    # MLA
    (r"attn/w_q$", (None, MODEL_AXIS)),
    (r"attn/w_dkv$", (None, None)),
    (r"attn/w_ukv$", (None, MODEL_AXIS)),
    (r"attn/w_o$", (MODEL_AXIS, None)),
    # dense MLPs (block + MoE shared expert)
    (r"(w_gate|w_up|w_fc)$", (None, MODEL_AXIS)),
    (r"(w_down|w_proj)$", (MODEL_AXIS, None)),
    (r"b_fc$", (MODEL_AXIS,)),
    (r"b_proj$", (None,)),
    # MoE experts: EP on model
    (r"moe/w_(gate|up)_e$", (MODEL_AXIS, None, None)),
    (r"moe/w_down_e$", (MODEL_AXIS, None, None)),
    (r"moe/router$", (None, None)),
    # Mamba-2
    (r"mixer/w_in$", (None, MODEL_AXIS)),
    (r"mixer/w_out$", (MODEL_AXIS, None)),
    (r"mixer/conv_w$", (None, MODEL_AXIS)),
    # RG-LRU
    (r"mixer/w_(x|gate_branch|a_gate|i_gate)$", (None, MODEL_AXIS)),
    # norms / scalars / small vectors: replicated
    (r".*", ()),
]


def param_pspec(name: str, ndim: int) -> Placement:
    """The rule's placement of leaf ``name`` at rank ``ndim``, one entry per
    dim (a stacked ``body/`` leaf gets ``None`` on its layer axis)."""
    stacked = re.search(r"(^|/)body/", name) is not None
    base_ndim = ndim - 1 if stacked else ndim
    spec = next(spec for regex, spec in _RULES if re.search(regex, name))
    spec = (tuple(spec) + (None,) * base_ndim)[:base_ndim]
    return (None,) + spec if stacked else spec


def cache_pspecs(mesh, cache: dict, *, kv_shard: str = "seq") -> dict:
    """The placement of every leaf of a slab serving cache (the reference's
    ``cache_pspecs``): lane lengths and 1-D leaves over the data axes; SSM
    states ``(B, H, P, N)`` their heads on ``model``; every other leaf its
    lanes over the data axes and, with ``kv_shard="seq"``, its per-lane
    sequence axis on ``model`` (context-parallel decode), with
    ``"feature"`` its last axis.  A stacked ``body/`` leaf gets ``None`` on
    its layer axis first.  Unsanitized, as the reference returns them."""
    dp = _dp(mesh)

    def leaf(name, x):
        nd = x.dim()
        if name.endswith("len") or nd <= 1:
            return (dp,) + (None,) * max(0, nd - 1)
        stacked = re.search(r"(^|/)body/", name) is not None
        if stacked:
            nd -= 1
        if nd == 4 and "state" in name:
            spec = (dp, MODEL_AXIS, None, None)
        elif nd >= 2:
            spec = ((dp, MODEL_AXIS) + (None,) * (nd - 2) if kv_shard == "seq"
                    else (dp,) + (None,) * (nd - 2) + (MODEL_AXIS,))
        else:
            spec = (dp,)
        return (None,) + spec if stacked else spec

    return tree_map_with_name(leaf, cache)


def sanitize_spec(spec: Placement, shape: tuple, mesh) -> Placement:
    """Drop the sharding of any dim whose size its mesh axes do not divide
    (odd vocab sizes, MQA's one KV head and small shapes replicate on that
    dim only)."""
    sizes = axis_sizes(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        k = 1
        for a in entry if isinstance(entry, tuple) else (entry,):
            k *= sizes.get(a, 1)
        out.append(entry if (k > 0 and dim % k == 0) else None)
    return tuple(out)
