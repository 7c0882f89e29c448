"""Compressed N:M matmul ``y = x @ decompress(values, indices)``.

Replaces the TPU kernel ``src/repro/kernels/nm_spmm.py:_nm_spmm_kernel``
(launched by ``nm_spmm_pallas``).  On the card :func:`nm_spmm` launches the
hand-written CUDA kernels in ``csrc/nm_spmm.cu``: for ``B <= 8`` rows (and
x that fits a block's shared memory) a decode kernel that keeps a ring of
16 or 32 kept weight rows in flight per lane; for more rows of bf16 x a
tensor-core body that expands each step's compressed tile in shared
memory and runs ``mma.sync`` on it, with the tile :func:`prefill_plan`
picks from the weight's shapes; else (f32 x of more than 8 rows, or a
decode x past the staging budget) the first version's body.  Each sums
every output in one order fixed by the weight's shapes, so a row of x
gives the same bytes whatever other rows share its call; decode and f32
keep the first version's order, bf16 prefill has its own (the source's
header says what bounds each kernel and how the design answers it).  On
the CPU it runs :func:`nm_spmm_plain`, the two regimes of the reference's
``nm_spmm_xla``.

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
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import SMEM_MAX

# at or below this many rows the plain version gathers activations instead
# of decompressing (the reference's GATHER_ROWS)
GATHER_ROWS = 8
# the decode kernel (csrc/nm_spmm.cu) takes B <= DECODE_ROWS rows and
# stages all of x in a block (at most X_SMEM_BYTES: two blocks an SM); its
# lanes take 4 columns each where that still makes MIN_WIDE_BLOCKS blocks
DECODE_ROWS, X_SMEM_BYTES, MIN_WIDE_BLOCKS = 8, 96 * 1024, 80
# the tensor-core body (csrc/nm_spmm.cu: nm_spmm_tc): its output tiles
# (rows, columns) for one weight and for expert stacks; the dense columns
# a chained pair of k16 MMAs sums (a step is a multiple of them and of m)
TC_SMALL, TC_EXPERTS = (64, 64), (32, 128)
TC_KCHUNK = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_ARGTYPES_BATCHED = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


class PrefillPlan(NamedTuple):
    """The tensor-core body's launch plan: a block's output tile of
    ``rows`` x ``cols`` and the dense columns of K a step takes
    (``depth``).  All zeros: the first version's body."""

    rows: int
    cols: int
    depth: int


FIRST_BODY = PrefillPlan(0, 0, 0)


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


def prefill_smem_bytes(plan: PrefillPlan, n: int, m: int) -> int:
    """Bytes of shared memory the tensor-core body takes (``csrc/nm_spmm.cu``:
    ``tc_smem_bytes``): two stages of an x tile (rows padded by 8 bf16),
    compressed values and uint8 offsets, then the dense bf16 tile (rows
    padded by 8).  The launch refuses a plan past ``SMEM_MAX``."""
    kept = plan.depth // m * n
    stage = plan.rows * (plan.depth + 8) * 2 + kept * plan.cols * 3
    return 2 * stage + plan.depth * (plan.cols + 8) * 2


def prefill_plan(k: int, o: int, e: int, n: int, m: int, itemsize: int) -> PrefillPlan:
    """The tensor-core body's plan for bf16 x of more than
    :data:`DECODE_ROWS` rows, from the weight's shapes, never from B (and
    no plan moves a row's bytes: every tile and depth sums each output in
    the one order of the source's header):

    - the tile: :data:`TC_EXPERTS` for an expert stack (``e > 1``: few
      rows an expert), else :data:`TC_SMALL`; :data:`TC_SMALL` where the
      first does not fit :data:`SMEM_MAX`.  (``scripts/nm_spmm_tiles.py``
      times the tiles at the rows the serving runs give each weight: no
      tile changes a byte, and a 256 x 128 tile, faster only where B
      fills many of its row tiles, lost at short prompts on every weight);
    - ``depth``: the least multiple of ``m`` and :data:`TC_KCHUNK` that is
      at least 64, where that is at most 256.

    Raises ``ValueError`` for what the body does not take: f32 (its
    instances keep the first version's body), 1 <= n <= m <= 256 broken,
    an ``m`` whose steps would pass 256 columns, or no tile that fits."""
    if itemsize != 2:
        raise ValueError(f"the tensor-core body takes bf16, not {itemsize}-byte elements")
    if not 1 <= n <= m <= 256:
        raise ValueError(f"the tensor-core body takes 1 <= n <= m <= 256, got {n}:{m}")
    unit = math.lcm(m, TC_KCHUNK)
    depth = unit * max(1, 64 // unit)
    if depth > 256:
        raise ValueError(f"m={m}: the tensor-core body's steps would span {depth} > 256 columns")
    first = TC_EXPERTS if e > 1 else TC_SMALL
    for tile in dict.fromkeys((first, TC_SMALL)):
        plan = PrefillPlan(*tile, depth)
        if prefill_smem_bytes(plan, n, m) <= SMEM_MAX:
            return plan
    raise ValueError(f"{n}:{m} needs more than a block's {SMEM_MAX} B of shared memory")


def launch_plan(b: int, k: int, o: int, o_true: int, e: int, n: int, m: int, itemsize: int,
                aligned: bool) -> tuple[int, PrefillPlan]:
    """What one launch runs: :func:`decode_cols`'s columns (0: not the
    decode kernel) and, for bf16 x (``itemsize`` 2) of more than
    :data:`DECODE_ROWS` rows, :func:`prefill_plan`'s tile; a decode x
    past the staging budget, and f32 x of more rows, take the first
    version's body (:data:`FIRST_BODY`)."""
    cols = decode_cols(b, k, o, o_true, e, itemsize, aligned)
    if b > DECODE_ROWS and itemsize == 2:
        return cols, prefill_plan(k, o, e, n, m, itemsize)
    return cols, FIRST_BODY


def _run(name, symbol, argtypes, x, values, indices, y, e, n, m, o_true):
    """One launch of entry ``name`` with :func:`launch_plan`'s plan."""
    b, k = x.shape[-2:]
    o = values.shape[-1]
    size = x.element_size()
    cols, plan = launch_plan(b, k, o, o_true, e, n, m, size,
                             values.data_ptr() % (4 * size) == 0 and indices.data_ptr() % 4 == 0)
    fn = dispatch.kernel_fn("nm_spmm", symbol, argtypes)
    lead = (e,) if symbol == "nm_spmm_batched_launch" else ()
    rc = fn(x.data_ptr(), values.data_ptr(), indices.data_ptr(), y.data_ptr(), *lead, b, k, o,
            o_true, n, m, cols, *plan, _DTYPES[x.dtype], dispatch.stream_ptr(x.device))
    dispatch.check_launch(name, rc)
    route = "decode" if cols else ("body" if plan == FIRST_BODY else "tc")
    dispatch.routes[f"{name}/{route}"] += 1


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
