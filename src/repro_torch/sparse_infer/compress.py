"""The deployable N:M-compressed model (counterpart of ``repro/sparse_infer/compress.py``).

``compress_params`` replaces every maskable leaf with a
:class:`CompressedTensor` (kept values + uint8 in-group offsets);
``export_compressed`` exports and compresses a tree leaf by leaf, within
the memory a full-size MoE model leaves on one card.  That tree
is served directly: ``models.layers.matmul`` routes compressed leaves
through ``kernels.nm_spmm``, so the dense weight never exists on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.masking import nm_compress, nm_decompress
from repro_torch.core.recipes import mask_leaf
from repro_torch.core.sparsity_config import SparsityConfig
from repro_torch.utils.tree import tree_items, tree_map_with_name


@dataclasses.dataclass(frozen=True, eq=False)
class CompressedTensor:
    """An N:M-compressed weight.

    ``values``/``indices`` are ``(..., K·n/m, O)`` for a dense ``(..., K,
    O_true)`` weight.  ``shape`` is the dense shape at construction; ``pad``
    counts alignment columns appended to the last axis at compress time
    (JAX exports made for a TPU carry them), which the matmul strips.

    On a tensor-parallel rank the leaf may be one shard of the whole
    (``distributed.compressed_pspecs.shard_serving_params``): ``rshards``
    (the reference's field) counts the model-axis shards of the reduction
    axis, whole N:M groups each, and ``oshards`` those of the output axis;
    ``values``/``indices`` then hold this rank's slice, and ``shape`` and
    ``pad`` stay the whole leaf's.
    """

    values: torch.Tensor
    indices: torch.Tensor  # uint8 in-group offsets
    n: int
    m: int
    group_axis: int
    shape: tuple
    pad: int = 0
    rshards: int = 1  # model-axis shards of the group (reduction) axis
    oshards: int = 1  # model-axis shards of the output axis

    def dense(self) -> torch.Tensor:
        d = nm_decompress(self.values, self.indices, self.n, self.m, self.group_axis)
        return d[..., : d.shape[-1] - self.pad] if self.pad else d

    @property
    def out_features(self) -> int:
        """True (unpadded) width of the whole leaf's last axis."""
        return self.values.shape[-1] * self.oshards - self.pad

    @property
    def nbytes(self) -> int:
        """Stored bytes, alignment padding included."""
        return (
            self.values.numel() * self.values.element_size()
            + self.indices.numel() * self.indices.element_size()
        )

    def shard(self, axis: int, index: int, shards: int) -> "CompressedTensor":
        """Shard ``index`` of ``shards`` equal slices of ``values`` and
        ``indices`` along ``axis``: the reduction axis (-2, then
        ``rshards = shards``; the caller keeps whole N:M groups per shard)
        or the output axis (-1, ``oshards = shards``).  Views, not copies."""
        nd = self.values.dim()
        axis %= nd
        if axis not in (nd - 2, nd - 1) or self.values.shape[axis] % shards:
            raise ValueError(f"cannot split axis {axis} of {tuple(self.values.shape)} "
                             f"into {shards} shards")
        n = self.values.shape[axis] // shards
        field = "rshards" if axis == nd - 2 else "oshards"
        return dataclasses.replace(
            self, values=self.values.narrow(axis, index * n, n),
            indices=self.indices.narrow(axis, index * n, n), **{field: shards})

    def layer(self, i: int) -> "CompressedTensor":
        """Layer ``i`` of a stacked ``(L, K·n/m, O)`` leaf, as views."""
        return dataclasses.replace(
            self, values=self.values[i], indices=self.indices[i],
            group_axis=self.group_axis % self.values.ndim - 1,
        )


def compress_params(params: dict, cfg: SparsityConfig) -> dict:
    """Replace every maskable leaf with its N:M-compressed form."""

    def leaf(name, p):
        pat = cfg.pattern_for(name, tuple(p.shape))
        if pat is None:
            return p
        v, i = nm_compress(p, pat.n, pat.m, pat.group_axis)
        return CompressedTensor(v, i, pat.n, pat.m, pat.group_axis, tuple(p.shape))

    return tree_map_with_name(leaf, params)


def export_compressed(params: dict, recipe, *, compress: bool = True) -> tuple[dict, dict]:
    """``compress_params(recipe.export_sparse(params), recipe.sparsity)``
    (with ``compress=False``, the export alone) and its
    :func:`compression_report`, built one leaf at a time and a stacked leaf
    one slice of its leading axis at a time.

    ``params`` is consumed: each leaf leaves it once its replacement
    exists, so peak memory stays near the dense tree plus one leaf's result
    and one slice's temporaries (the whole-tree functions hold the dense
    tree, its masked copy, the masks and the int64 indices of whole leaves
    at once).  Masks and compression act on each slice independently, so
    the result is bit-identical to the whole-tree functions'."""
    report = {"dense_bytes": 0, "compressed_bytes": 0}

    def leaf(name: str, p: torch.Tensor):
        nbytes = p.numel() * p.element_size()
        report["dense_bytes"] += nbytes
        pat = recipe.sparsity.pattern_for(name, tuple(p.shape))
        if pat is None:
            report["compressed_bytes"] += nbytes
            return p
        axis = pat.group_axis % p.ndim

        def one(w, ax):
            masked = w if recipe.kind == "dense" else mask_leaf(w, pat.n, pat.m, ax)[0]
            return nm_compress(masked, pat.n, pat.m, ax) if compress else (masked,)

        if p.ndim < 3 or axis == 0:
            parts = one(p, axis)
        else:  # slice by slice into preallocated stacks
            parts = None
            for i in range(p.shape[0]):
                res = one(p[i], axis - 1)
                if parts is None:
                    parts = tuple(torch.empty((p.shape[0],) + r.shape, dtype=r.dtype,
                                              device=r.device) for r in res)
                for whole, r in zip(parts, res):
                    whole[i] = r
        if not compress:
            report["compressed_bytes"] += nbytes * pat.n // pat.m + p.numel() * pat.n // pat.m
            return parts[0]
        out = CompressedTensor(*parts, pat.n, pat.m, pat.group_axis, tuple(p.shape))
        report["compressed_bytes"] += out.nbytes
        return out

    def walk(tree: dict, prefix: str) -> dict:
        out = {}
        for k in list(tree):
            name = f"{prefix}/{k}" if prefix else str(k)
            v = tree.pop(k)
            out[k] = walk(v, name) if isinstance(v, dict) else leaf(name, v)
            del v  # the dense leaf goes now, not at the end of the walk
        return out

    tree = walk(params, "")
    report["ratio"] = report["compressed_bytes"] / max(report["dense_bytes"], 1)
    return tree, report


def decompress_params(params: dict) -> dict:
    """Rehydrate a compressed tree to dense: exactly the masked-dense tree it
    was compressed from (the speculative verifier of ``launch/serve.py``;
    decode never calls this).  A stacked leaf is expanded one slice of its
    leading axis at a time into its preallocated result, so the
    temporaries stay one slice's (a full-width DeepSeek-V2-Lite's expert
    stacks are 9.6 GB a leaf dense)."""

    def leaf(_, x):
        if not isinstance(x, CompressedTensor):
            return x
        if x.values.dim() < 3 or x.group_axis % x.values.dim() == 0:
            return x.dense()
        out = None
        for i in range(x.values.shape[0]):
            d = x.layer(i).dense()
            if out is None:
                out = torch.empty((x.values.shape[0],) + tuple(d.shape), dtype=d.dtype,
                                  device=d.device)
            out[i] = d
        return out

    return tree_map_with_name(leaf, params)


def tree_nbytes(tree: dict) -> int:
    """Stored bytes of a tree, compressed leaves at their compressed size."""
    return sum(
        x.nbytes if isinstance(x, CompressedTensor) else x.numel() * x.element_size()
        for _, x in tree_items(tree)
    )


def compression_report(params: dict, compressed: dict) -> dict:
    """Bytes before/after (the decode-roofline input)."""
    dense_b, comp_b = tree_nbytes(params), tree_nbytes(compressed)
    return {
        "dense_bytes": int(dense_b),
        "compressed_bytes": int(comp_b),
        "ratio": comp_b / max(dense_b, 1),
    }

