"""The deployable N:M-compressed model (counterpart of ``repro/sparse_infer/compress.py``).

``compress_params`` replaces every maskable leaf with a
:class:`CompressedTensor` (kept values + uint8 in-group offsets).  That tree
is served directly: ``models.layers.matmul`` routes compressed leaves
through ``kernels.nm_spmm``, so the dense weight never exists on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.masking import nm_compress, nm_decompress
from repro_torch.core.sparsity_config import SparsityConfig
from repro_torch.utils.tree import tree_items, tree_map_with_name


@dataclasses.dataclass(frozen=True, eq=False)
class CompressedTensor:
    """An N:M-compressed weight.

    ``values``/``indices`` are ``(..., K·n/m, O)`` for a dense ``(..., K,
    O_true)`` weight.  ``shape`` is the dense shape at construction; ``pad``
    counts alignment columns appended to the last axis at compress time
    (JAX exports made for a TPU carry them), which the matmul strips.
    """

    values: torch.Tensor
    indices: torch.Tensor  # uint8 in-group offsets
    n: int
    m: int
    group_axis: int
    shape: tuple
    pad: int = 0

    def dense(self) -> torch.Tensor:
        d = nm_decompress(self.values, self.indices, self.n, self.m, self.group_axis)
        return d[..., : d.shape[-1] - self.pad] if self.pad else d

    @property
    def out_features(self) -> int:
        """True (unpadded) width of the last axis."""
        return self.values.shape[-1] - self.pad

    @property
    def nbytes(self) -> int:
        """Stored bytes, alignment padding included."""
        return (
            self.values.numel() * self.values.element_size()
            + self.indices.numel() * self.indices.element_size()
        )

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


def decompress_params(params: dict) -> dict:
    """Rehydrate a compressed tree to dense (parity tests only; serving never
    calls this)."""
    return tree_map_with_name(
        lambda _, x: x.dense() if isinstance(x, CompressedTensor) else x, params
    )


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

