"""Single-query paged decode attention over a ``(P, ps, Hkv, D)`` pool.

Replaces the TPU kernel ``src/repro/kernels/paged_attn.py:_paged_attn_kernel``
(launched by ``paged_attn_pallas`` with ``emit_stats=False``) in the form
the main path runs: MHA/GQA, append-only tables, fp pages.  Its window,
int8-scale and MLA (``q2``/``k2_pages``/``v_is_k``) options and the
stats-emitting variant are not ported (ROADMAP.md §2); this wrapper has no
such arguments.

On the card :func:`paged_attn` launches ``csrc/paged_attn.cu`` (whose
header says what bounds it and how the design answers that); on the CPU it
runs :func:`paged_attn_plain`, the gathered math of the reference's
``_gathered_stats``/``paged_attn_xla``.

Operands: q ``(B, Hkv, G, D)``; k/v pages ``(P, ps, Hkv, D|Dv)``; tables
``(B, n_slots)`` int32 with sentinel ``P`` for unmapped slots; lengths
``(B,)`` int32 live tokens per lane.  Returns ``(B, Hkv, G, Dv)`` in
``q.dtype``; lanes of length 0 return exact zeros.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import dispatch

_NEG = -1e30  # finite -inf stand-in: keeps dead lanes exp()-safe
_SMEM_LIMIT = 48 * 1024  # dynamic shared memory without an opt-in attribute
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def paged_attn(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    tables: torch.Tensor, lengths: torch.Tensor, *, scale: float,
) -> torch.Tensor:
    if dispatch.on_card(q, k_pages, v_pages, tables, lengths):
        return _launch(q, k_pages, v_pages, tables, lengths, scale)
    return paged_attn_plain(q, k_pages, v_pages, tables, lengths, scale=scale)


def _check(q, k_pages, v_pages, tables, lengths) -> None:
    b, hkv, _, d = q.shape
    if (k_pages.dim() != 4 or v_pages.dim() != 4
            or k_pages.shape[:3] != v_pages.shape[:3]
            or k_pages.shape[2:] != (hkv, d)):
        raise ValueError(f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {b}")


def _launch(q, k_pages, v_pages, tables, lengths, scale):
    _check(q, k_pages, v_pages, tables, lengths)
    if q.dtype not in _DTYPES or not (k_pages.dtype == v_pages.dtype == q.dtype):
        raise TypeError(f"paged_attn kernel takes f32 or bf16 q/k/v of one type, "
                        f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages, tables, lengths)):
        raise ValueError("paged_attn kernel needs contiguous operands")
    b, hkv, g, d = q.shape
    n_pages, ps = k_pages.shape[:2]
    dv = v_pages.shape[-1]
    smem = dispatch.kernel_fn(
        "paged_attn", "paged_attn_smem_bytes", [ctypes.c_int] * 4)(g, d, dv, ps)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"G={g}, D={d}, Dv={dv}, ps={ps} need {smem} B of "
                         f"shared memory, over the kernel's {_SMEM_LIMIT}")
    out = torch.empty((b, hkv, g, dv), dtype=q.dtype, device=q.device)
    if b == 0 or hkv == 0:
        return out
    fn = dispatch.kernel_fn("paged_attn", "paged_attn_launch", _ARGTYPES)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, hkv, g, d, dv, n_pages, ps, tables.shape[1], float(scale),
            _DTYPES[q.dtype], dispatch.stream_ptr(q.device))
    dispatch.check_launch("paged_attn", rc)
    return out


def paged_attn_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    tables: torch.Tensor, lengths: torch.Tensor, *, scale: float,
) -> torch.Tensor:
    """The same function in plain PyTorch: gather every lane's table slots
    into a ``(B, n_slots·ps)`` view and apply the per-position masks in one
    f32 softmax."""
    _check(q, k_pages, v_pages, tables, lengths)
    n_pages, ps = k_pages.shape[:2]
    apos = (torch.arange(tables.shape[1], device=q.device)[:, None] * ps
            + torch.arange(ps, device=q.device))  # (S, ps)
    valid = (apos[None] < lengths.long()[:, None, None]) & (
        tables[..., None] != n_pages)  # (B, S, ps)
    phys = tables.long().clamp(0, n_pages - 1)  # sentinel rows are masked
    s = torch.einsum("bhgd,bsphd->bhgsp", q.float(), k_pages[phys].float())
    s = torch.where(valid[:, None, None], s * scale, _NEG)
    mx = s.amax(dim=(-2, -1), keepdim=True)  # _NEG on dead lanes
    pexp = torch.exp(s - mx) * valid[:, None, None]
    l = pexp.sum(dim=(-2, -1))
    acc = torch.einsum("bhgsp,bsphd->bhgd", pexp, v_pages[phys].float())
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
