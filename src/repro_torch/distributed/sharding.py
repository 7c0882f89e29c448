"""Sharding rules: parameter names -> placements (counterpart of
``repro/distributed/sharding.py``).

A placement is a tuple with one entry per dim of the leaf: ``None``
(replicated along that dim) or a mesh axis name (or a tuple of names), the
contents of the reference's ``PartitionSpec`` as plain Python data.  The
rules are the reference's: Megatron-style tensor parallelism on the
``model`` axis (q/k/v, gate/up and fc column-sharded, o, down and proj
row-sharded, embeddings vocab-sharded, MoE experts on ``model``) and, with
``fsdp``, ZeRO-3-style ``data`` on the other major dim of every big matmul
weight.  Serving takes them with FSDP off (decode reads every weight each
step; ``compressed_pspecs``).  :func:`batch_pspecs` places a training
batch (its leading dim over the data axes: the rows each data-parallel
rank trains on), :func:`state_pspecs` a whole ``TrainState`` (moments,
preconditioner and error-feedback residual mirror their parameter), and
:func:`cache_pspecs` a slab cache.  Data-parallel training holds the
state whole on every rank (``fsdp=False`` placements); FSDP execution is
not ported (ROADMAP.md).

A mesh here is anything with ``axis_names`` and a ``devices`` array of
the mesh's shape: ``launch.mesh.Mesh`` or a stand-in.
"""
from __future__ import annotations

import re

from repro_torch.utils.tree import tree_map_with_name, tree_unflatten_like

MODEL_AXIS = "model"
DP_AXES = ("pod", "data")  # pod omitted automatically on single-pod meshes

Placement = tuple


def axis_sizes(mesh) -> dict:
    """Axis name -> size."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _dp(mesh):
    axes = tuple(a for a in DP_AXES if a in mesh.axis_names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


# (regex over the leaf name, placement given the FSDP axis ``d``)
# — first match wins.  Placements are written for the *unstacked* rank; a
# leading None is prepended for "body/" leaves.
def _rules(fsdp: bool) -> list:
    d = "data" if fsdp else None
    return [
        # embeddings: vocab on model, feature on data (fsdp)
        (r"tok_embed$", (MODEL_AXIS, d)),
        (r"out_embed$", (d, MODEL_AXIS)),
        (r"frontend_proj$", (None, d)),
        # attention
        (r"attn/w(q|k|v)$", (d, MODEL_AXIS)),
        (r"attn/wo$", (MODEL_AXIS, d)),
        (r"attn/bias_(q|k|v)$", (MODEL_AXIS,)),
        (r"attn/bias_o$", (None,)),
        # MLA
        (r"attn/w_q$", (d, MODEL_AXIS)),
        (r"attn/w_dkv$", (d, None)),
        (r"attn/w_ukv$", (d, MODEL_AXIS)),
        (r"attn/w_o$", (MODEL_AXIS, d)),
        # dense MLPs (block + MoE shared expert)
        (r"(w_gate|w_up|w_fc)$", (d, MODEL_AXIS)),
        (r"(w_down|w_proj)$", (MODEL_AXIS, d)),
        (r"b_fc$", (MODEL_AXIS,)),
        (r"b_proj$", (None,)),
        # MoE experts: EP on model, fsdp on d_ff
        (r"moe/w_(gate|up)_e$", (MODEL_AXIS, None, d)),
        (r"moe/w_down_e$", (MODEL_AXIS, d, None)),
        (r"moe/router$", (None, None)),
        # Mamba-2
        (r"mixer/w_in$", (d, MODEL_AXIS)),
        (r"mixer/w_out$", (MODEL_AXIS, d)),
        (r"mixer/conv_w$", (None, MODEL_AXIS)),
        # RG-LRU
        (r"mixer/w_(x|gate_branch|a_gate|i_gate)$", (d, MODEL_AXIS)),
        # norms / scalars / small vectors: replicated
        (r".*", ()),
    ]


_RULES = {fsdp: _rules(fsdp) for fsdp in (False, True)}


def param_pspec(name: str, ndim: int, *, fsdp: bool = True) -> Placement:
    """The rule's placement of leaf ``name`` at rank ``ndim``, one entry per
    dim (a stacked ``body/`` leaf gets ``None`` on its layer axis); the
    reference's default, FSDP on."""
    stacked = re.search(r"(^|/)body/", name) is not None
    base_ndim = ndim - 1 if stacked else ndim
    spec = next(spec for regex, spec in _RULES[fsdp] if re.search(regex, name))
    spec = (tuple(spec) + (None,) * base_ndim)[:base_ndim]
    return (None,) + spec if stacked else spec


def _ndim(x) -> int:
    return len(getattr(x, "shape", ()))


def batch_pspecs(mesh, batch: dict) -> dict:
    """A training batch's placements: each leaf's leading dim over the data
    axes, the rest replicated."""
    dp = _dp(mesh)
    return tree_map_with_name(lambda _, x: (dp,) + (None,) * (_ndim(x) - 1), batch)


def state_pspecs(mesh, state, *, fsdp: bool = True):
    """The placements of a whole ``TrainState``, in its structure: a leaf of
    rank >= 2 (a parameter, its moments, preconditioner or error-feedback
    residual) takes its parameter's rule, the name found by dropping the
    state's leading path segments down to the parameter's (any path that
    reaches the rules ends in the parameter's name); scalars, ring buffers
    and step counters are replicated."""
    return tree_unflatten_like(
        state, lambda name, x: (param_pspec(name, _ndim(x), fsdp=fsdp) if _ndim(x) >= 2
                                else ()))


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
