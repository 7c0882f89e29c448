"""N:M structured-sparsity mask math (counterpart of ``repro/core/masking.py``).

An N:M mask keeps the N largest-magnitude elements of every group of M
consecutive elements along ``group_axis``.  Ties break toward the lower
index, as ``jax.lax.top_k`` does in the reference.  ``torch.topk`` does not
promise that order (on ``[1,3,3,3]`` with k=2 it returns ``[2,3]`` where JAX
returns ``[1,2]``), so the top-n is taken from a *stable* descending sort,
which keeps equal magnitudes in index order.

The Straight-Through Estimator primitives of the training recipes (paper
Eq. 8/9) sit at the end; the per-step mask itself comes from
``kernels.nm_mask``, whose plain version is :func:`nm_mask` with a select.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class NMSparsity:
    """Keep ``n`` of every ``m`` consecutive elements along ``group_axis``."""

    n: int
    m: int
    group_axis: int = 0

    def __post_init__(self):
        if not (1 <= self.n <= self.m):
            raise ValueError(f"need 1 <= N <= M, got {self.n}:{self.m}")

    @property
    def density(self) -> float:
        return self.n / self.m

    def __str__(self) -> str:  # "2:4"
        return f"{self.n}:{self.m}"


def _groups(w: torch.Tensor, m: int, axis: int) -> torch.Tensor:
    """``w`` with ``axis`` moved last and split into ``(..., G, m)``."""
    if w.shape[axis] % m != 0:
        raise ValueError(
            f"axis {axis} of shape {tuple(w.shape)} not divisible by group size {m}"
        )
    wt = w.movedim(axis, -1)
    return wt.reshape(wt.shape[:-1] + (wt.shape[-1] // m, m))


def _top_n(groups: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the n largest ``|groups|`` per group, lower index first
    among equals (``jax.lax.top_k`` order)."""
    order = torch.sort(groups.abs(), dim=-1, descending=True, stable=True).indices
    return order[..., :n]


def nm_mask(w: torch.Tensor, n: int, m: int, group_axis: int = 0) -> torch.Tensor:
    """Binary N:M mask of ``w`` by magnitude, in ``w.dtype``."""
    if n == m:
        return torch.ones_like(w)
    axis = group_axis % w.ndim
    groups = _groups(w, m, axis)
    mask = torch.zeros_like(groups)
    mask.scatter_(-1, _top_n(groups, n), 1)
    mask = mask.reshape(mask.shape[:-2] + (-1,))
    return mask.movedim(-1, axis)


def nm_compress(
    w: torch.Tensor, n: int, m: int, group_axis: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)``: the kept elements along ``group_axis`` (size
    ``dim·n/m`` there) and their uint8 offsets within each group of ``m``,
    sorted ascending within a group."""
    axis = group_axis % w.ndim
    groups = _groups(w, m, axis)
    idx = torch.sort(_top_n(groups, n), dim=-1).values
    vals = torch.gather(groups, -1, idx)
    out_shape = groups.shape[:-2] + (groups.shape[-2] * n,)
    vals = vals.reshape(out_shape).movedim(-1, axis).contiguous()
    idx = idx.to(torch.uint8).reshape(out_shape).movedim(-1, axis).contiguous()
    return vals, idx


def nm_decompress(
    values: torch.Tensor, indices: torch.Tensor, n: int, m: int,
    group_axis: int = 0,
) -> torch.Tensor:
    """Scatter an N:M-compressed ``(values, indices)`` pair back to dense."""
    axis = group_axis % values.ndim
    vt = values.movedim(axis, -1)
    it = indices.movedim(axis, -1).long()
    g = vt.shape[-1] // n
    vt = vt.reshape(vt.shape[:-1] + (g, n))
    it = it.reshape(it.shape[:-1] + (g, n))
    dense = torch.zeros(vt.shape[:-1] + (m,), dtype=values.dtype, device=values.device)
    dense.scatter_(-1, it, vt)
    return dense.reshape(dense.shape[:-2] + (g * m,)).movedim(-1, axis)


def nm_mask_dynamic(w: torch.Tensor, n: int, m: int, group_axis: int = 0) -> torch.Tensor:
    """N:M mask by in-group rank: ``mask[i] = rank(|w[i]|) < n``, the rank
    taken by a stable descending sort (lower index first among equals).

    The reference needs this form because its ``n`` is traced inside a
    jitted step (the Decaying-Mask recipe).  Here ``n`` is a host integer,
    so it is the same mask as :func:`nm_mask`; both keep the lower index on
    ties."""
    axis = group_axis % w.ndim
    groups = _groups(w, m, axis)
    order = torch.sort(groups.abs(), dim=-1, descending=True, stable=True).indices
    rank = torch.argsort(order, dim=-1)
    mask = (rank < n).to(w.dtype)
    return mask.reshape(mask.shape[:-2] + (-1,)).movedim(-1, axis)


def sparsity_fraction(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of zeros in a mask (1 - density)."""
    return 1.0 - mask.float().mean()


# ---------------------------------------------------------------------------
# Straight-Through Estimator primitives (paper Eq. 8 / Eq. 9).
# ---------------------------------------------------------------------------


class _StraightThrough(torch.autograd.Function):
    """Forward: the given masked weight ``Π⊙w``.  Backward: the incoming
    gradient, unchanged, to the dense ``w``; nothing to the mask."""

    @staticmethod
    def forward(ctx, w: torch.Tensor, masked: torch.Tensor) -> torch.Tensor:
        return masked

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def straight_through(w: torch.Tensor, masked: torch.Tensor) -> torch.Tensor:
    """STE on a precomputed ``masked = Π⊙w`` (the ``nm_mask`` kernel's
    output): the loss sees ``masked``, the full gradient reaches ``w``."""
    return _StraightThrough.apply(w, masked.detach())


def straight_through_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``mask * w`` in the forward pass; identity gradient to ``w`` (STE,
    Eq. 8), which lets pruned weights regrow and the mask keep evolving.

    ``w * mask`` alone would give the masked gradient, which is ASP's
    (:func:`masked_no_ste`), not STE's."""
    return straight_through(w, w.detach() * mask)


def masked_no_ste(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``mask * w`` with the true gradient ``mask * g`` (ASP: the mask is
    fixed and pruned weights stay dead)."""
    return w * mask.detach()


def sr_ste_grad_term(w: torch.Tensor, mask: torch.Tensor, lam: float) -> torch.Tensor:
    """The SR-STE term ``λ (1 − Π) ⊙ w`` (Eq. 9), added to the STE gradient
    so pruned weights decay towards zero and the mask stabilizes.  Evaluated
    as the reference does, ``(λ·(1 − Π))·w``, with its type promotions."""
    return lam * (1.0 - mask) * w
