"""Compressed N:M matmul ``y = x @ decompress(values, indices)``.

Replaces the TPU kernel ``src/repro/kernels/nm_spmm.py:_nm_spmm_kernel``
(launched by ``nm_spmm_pallas``).  On the card :func:`nm_spmm` launches the
hand-written CUDA kernels in ``csrc/nm_spmm.cu``: for ``B <= 8`` rows (and
x that fits a block's shared memory) a decode kernel that keeps a ring of
16 or 32 kept weight rows in flight per lane, else the first version's
body.  Both sum every
output in one fixed order, so a row of x gives the same bytes whatever
other rows share its call (the source's header says what bounds each
kernel and how the design answers it).  On the CPU it runs
:func:`nm_spmm_plain`, the two regimes of the reference's ``nm_spmm_xla``.

Layout: ``values``/``indices`` are ``(K·n/m, O)`` row-major; compressed row
``r`` belongs to group ``r // n`` and expands to dense row
``(r // n)·m + indices[r, o]``.  ``o_true`` strips a padded artifact's
alignment columns.

:func:`nm_spmm_batched` is the same product over a stack of ``E``
independent operands (compressed MoE expert stacks ``(E, K·n/m, O)``), in
one launch where the reference vmaps the TPU kernel over the expert axis
(``src/repro/models/layers.py:66-74``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import dispatch

# at or below this many rows the plain version gathers activations instead
# of decompressing (the reference's GATHER_ROWS)
GATHER_ROWS = 8
# the decode kernel (csrc/nm_spmm.cu) takes B <= DECODE_ROWS rows and
# stages all of x in a block (at most X_SMEM_BYTES: two blocks an SM); its
# lanes take 4 columns each where that still makes MIN_WIDE_BLOCKS blocks
DECODE_ROWS, X_SMEM_BYTES, MIN_WIDE_BLOCKS = 8, 96 * 1024, 80
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_ARGTYPES_BATCHED = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def nm_spmm(
    x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor, n: int,
    m: int, o_true: Optional[int] = None,
) -> torch.Tensor:
    """``(x @ decompress(values, indices))[:, :o_true]`` in ``x.dtype``,
    accumulated in f32.  x ``(B, K)``; values/indices ``(K·n/m, O)``."""
    if dispatch.on_card(x, values, indices):
        return _launch(x, values, indices, n, m, o_true)
    return nm_spmm_plain(x, values, indices, n, m, o_true)


def _check(x, values, indices, n, m, o_true) -> int:
    if x.dim() != 2 or values.dim() != 2 or indices.shape != values.shape:
        raise ValueError(f"need x (B, K), values/indices (Kc, O); got "
                         f"{tuple(x.shape)}, {tuple(values.shape)}, {tuple(indices.shape)}")
    k, (kc, o) = x.shape[1], values.shape
    if not (1 <= n <= m) or k % m or kc * m != k * n:
        raise ValueError(f"{n}:{m} groups do not tile K={k} into {kc} rows")
    o_true = o if o_true is None else o_true
    if not 0 < o_true <= o:
        raise ValueError(f"o_true={o_true} outside (0, {o}]")
    return o_true


def _check_kernel(x, values, indices, m) -> None:
    """What the CUDA kernel takes, beyond the shapes."""
    if x.dtype not in _DTYPES or values.dtype != x.dtype:
        raise TypeError(f"nm_spmm kernel takes f32 or bf16 x and values of one "
                        f"type, got {x.dtype} and {values.dtype}")
    if indices.dtype != torch.uint8:
        raise TypeError(f"indices must be uint8, got {indices.dtype}")
    if m > 256:
        raise ValueError(f"group size m={m} exceeds the kernel's 256-column chunk")
    if not (x.is_contiguous() and values.is_contiguous() and indices.is_contiguous()):
        raise ValueError("nm_spmm kernel needs contiguous operands")


def decode_cols(b: int, k: int, o: int, o_true: int, e: int, itemsize: int,
                aligned: bool) -> int:
    """Columns a lane of the decode kernel takes, from the shapes alone: 4
    where ``o`` divides by 4, the operands lie on 4 of their elements
    (``aligned``) and the ``e`` products' blocks of 128 columns still number
    :data:`MIN_WIDE_BLOCKS`, else 1; 0 (the first version's body) for more
    than :data:`DECODE_ROWS` rows or an x beyond :data:`X_SMEM_BYTES` as the
    kernel stages it (4 or 8 rows: bf16 in pairs, f32 alone)."""
    rows = 4 if b <= 4 else DECODE_ROWS
    if b > DECODE_ROWS or k * rows * itemsize > X_SMEM_BYTES:
        return 0
    wide = o % 4 == 0 and aligned and -(-o_true // 128) * e >= MIN_WIDE_BLOCKS
    return 4 if wide else 1


def _run(name, symbol, argtypes, x, values, indices, y, e, n, m, o_true):
    """One launch of entry ``name`` with :func:`decode_cols`'s columns."""
    b, k = x.shape[-2:]
    o = values.shape[-1]
    size = x.element_size()
    cols = decode_cols(b, k, o, o_true, e, size, values.data_ptr() % (4 * size) == 0
                       and indices.data_ptr() % 4 == 0)
    fn = dispatch.kernel_fn("nm_spmm", symbol, argtypes)
    lead = (e,) if symbol == "nm_spmm_batched_launch" else ()
    rc = fn(x.data_ptr(), values.data_ptr(), indices.data_ptr(), y.data_ptr(), *lead, b, k, o,
            o_true, n, m, cols, _DTYPES[x.dtype], dispatch.stream_ptr(x.device))
    dispatch.check_launch(name, rc)


def _launch(x, values, indices, n, m, o_true):
    o_true = _check(x, values, indices, n, m, o_true)
    _check_kernel(x, values, indices, m)
    y = torch.empty((x.shape[0], o_true), dtype=x.dtype, device=x.device)
    if x.shape[0]:
        _run("nm_spmm", "nm_spmm_launch", _ARGTYPES, x, values, indices, y, 1, n, m, o_true)
    return y


def nm_spmm_plain(
    x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor, n: int,
    m: int, o_true: Optional[int] = None,
) -> torch.Tensor:
    """The same function in plain PyTorch, f32 math.

    ``B <= GATHER_ROWS``: gather the activation each kept weight multiplies
    and reduce against ``values`` (the dense weight never exists).  Larger
    ``B``: scatter-decompress to a dense ``(K, O)`` f32 weight and matmul.
    """
    o_true = _check(x, values, indices, n, m, o_true)
    b, k = x.shape
    g, o = k // m, values.shape[1]
    rows = (torch.arange(g, device=x.device)[:, None, None] * m
            + indices.long().reshape(g, n, o))  # dense row of each kept value
    vals = values.float().reshape(g, n, o)
    if b <= GATHER_ROWS:
        y = torch.einsum("bgno,gno->bo", x.float()[:, rows], vals)
    else:
        dense = torch.zeros((k, o), dtype=torch.float32, device=x.device)
        dense.scatter_(0, rows.reshape(g * n, o), vals.reshape(g * n, o))
        y = x.float() @ dense
    return y[:, :o_true].to(x.dtype)


def nm_spmm_batched(
    x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor, n: int,
    m: int, o_true: Optional[int] = None,
) -> torch.Tensor:
    """:func:`nm_spmm` of every expert: x ``(E, B, K)``, values/indices
    ``(E, K·n/m, O)`` -> ``(E, B, o_true)``, one launch on the card."""
    if dispatch.on_card(x, values, indices):
        return _launch_batched(x, values, indices, n, m, o_true)
    return nm_spmm_batched_plain(x, values, indices, n, m, o_true)


def _check_batched(x, values, indices) -> None:
    if x.dim() != 3 or values.dim() != 3 or x.shape[0] != values.shape[0]:
        raise ValueError(f"need x (E, B, K), values/indices (E, Kc, O); got "
                         f"{tuple(x.shape)}, {tuple(values.shape)}, {tuple(indices.shape)}")


def _launch_batched(x, values, indices, n, m, o_true):
    _check_batched(x, values, indices)
    o_true = _check(x[0], values[0], indices[0], n, m, o_true)
    _check_kernel(x, values, indices, m)
    e, b, _ = x.shape
    if e > 65535:
        raise ValueError(f"{e} experts exceed the grid's z extent 65535")
    y = torch.empty((e, b, o_true), dtype=x.dtype, device=x.device)
    if b:
        _run("nm_spmm_batched", "nm_spmm_batched_launch", _ARGTYPES_BATCHED, x, values,
             indices, y, e, n, m, o_true)
    return y


def nm_spmm_batched_plain(
    x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor, n: int,
    m: int, o_true: Optional[int] = None,
) -> torch.Tensor:
    """The same function in plain PyTorch: :func:`nm_spmm_plain` per expert."""
    _check_batched(x, values, indices)
    return torch.stack([nm_spmm_plain(x[e], values[e], indices[e], n, m, o_true)
                        for e in range(x.shape[0])])
