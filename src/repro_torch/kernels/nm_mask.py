"""Fused N:M mask computation and application: ``(Π⊙w, Π)``.

Replaces the TPU kernel ``src/repro/kernels/nm_mask.py:_nm_mask_kernel``
(launched by ``nm_mask_apply_pallas``), the per-step mask of every
STE-family recipe (paper Eq. 8) and the export mask.  On the card
:func:`nm_mask` launches the hand-written CUDA kernel in ``csrc/nm_mask.cu``
(whose header says what bounds it and how the design answers that); on the
CPU it runs :func:`nm_mask_plain`.

Layout: ``w`` is ``(..., R, C)`` with groups of ``m`` consecutive rows down
axis -2 (the reduction axis of an ``(in, out)`` weight); leading axes are
independent slices, so one launch covers a whole stacked ``(L, in, out)``
leaf.  In each group the ``n`` largest ``|w|`` are kept, ties to the lowest
index.  ``Π`` is in ``w.dtype``; ``Π⊙w`` is ``where(Π, w, 0)``, ``+0.0`` at
pruned entries as the Pallas kernel writes it (``mask * w`` would give
``-0.0`` for negative pruned weights).  ``n`` is a runtime argument, so the
Decaying-Mask recipe's shrinking ``n`` takes the same kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import masking
from repro_torch.kernels import dispatch

MAX_M = 32  # the kernel keeps a group in registers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(w: torch.Tensor, n: int, m: int) -> None:
    if w.dim() < 2:
        raise ValueError(f"nm_mask needs a (..., R, C) tensor, got {tuple(w.shape)}")
    if not 1 <= n <= m or w.shape[-2] % m:
        raise ValueError(f"{n}:{m} groups do not tile axis -2 of {tuple(w.shape)}")


def nm_mask(w: torch.Tensor, n: int, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Π⊙w, Π)`` for groups of ``m`` down axis -2 of ``w``.  ``n == m``
    keeps everything and launches nothing."""
    _check(w, n, m)
    if n == m:
        return w.clone(), torch.ones_like(w)
    if dispatch.on_card(w):
        return _launch(w, n, m)
    return nm_mask_plain(w, n, m)


def _launch(w: torch.Tensor, n: int, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    if w.dtype not in _DTYPES:
        raise TypeError(f"nm_mask kernel takes f32 or bf16, got {w.dtype}")
    if m > MAX_M:
        raise ValueError(f"group size m={m} exceeds the kernel's {MAX_M}")
    if not w.is_contiguous():
        raise ValueError("nm_mask kernel needs a contiguous tensor")
    masked, mask = torch.empty_like(w), torch.empty_like(w)
    if w.numel() == 0:
        return masked, mask
    r, c = w.shape[-2:]
    fn = dispatch.kernel_fn("nm_mask", "nm_mask_launch", _ARGTYPES)
    rc = fn(w.data_ptr(), masked.data_ptr(), mask.data_ptr(), w.numel() // (r * c),
            r, c, n, m, _DTYPES[w.dtype], dispatch.stream_ptr(w.device))
    dispatch.check_launch("nm_mask", rc)
    return masked, mask


def nm_mask_plain(w: torch.Tensor, n: int, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: the stable-sort
    ``masking.nm_mask`` and a select."""
    _check(w, n, m)
    mask = masking.nm_mask(w, n, m, group_axis=-2)
    return torch.where(mask != 0, w, torch.zeros((), dtype=w.dtype, device=w.device)), mask
