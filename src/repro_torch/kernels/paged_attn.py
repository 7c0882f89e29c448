"""Single-query paged decode attention over a ``(P, ps, Hkv, D)`` pool.

Replaces the TPU kernel ``src/repro/kernels/paged_attn.py:_paged_attn_kernel``
(launched by ``paged_attn_pallas``) in all its forms:

- MHA/GQA (K2): q ``(B, Hkv, G, D)``; k/v pages ``(P, ps, Hkv, D|Dv)``;
  append-only tables.
- Its window option (K2w, the reference's ``window``/``win_slots``): the
  same over a modular window table of ``win_slots`` slots, where slot
  ``p`` holds the newest logical page ``pg ≡ p (mod win_slots)`` at or
  before the lane's current page, and only positions ``>= length -
  window`` count (sliding-window layers, RecurrentGemma's local MQA).
- MLA's absorbed latent form (K2m, the reference's ``q2``/``k2_pages``/
  ``v_is_k``): a second score stream ``q2 (B, Hkv, G, D2)`` against
  ``k2_pages (P, ps, Hkv, D2)`` is added before the softmax, and V is the
  K pool itself (``v_pages`` is None).  DeepSeek's decode passes f32
  queries over bf16 pages and gets f32 back.
- Its int8-scale option (K2q, the reference's ``k_scale``/``v_scale``/
  ``k2_scale``), in each of the three forms above: int8 pages with one f16
  scale per (page, slot), ``(P, ps)``, per page stream; a row is its codes
  times its scale in f32 (``models.cache.dequant``).  The MLA form takes
  ``k_scale`` and ``k2_scale`` (V is the dequantized K page), the others
  ``k_scale`` and ``v_scale``.

Each form has two flushes.  The normalized one (K2, ``emit_stats=False``)
returns ``(B, Hkv, G, Dv)`` in ``q.dtype``; lanes of length 0 return exact
zeros.  The stats one (K3, ``emit_stats=True``, the reference's
``paged_attn_stats``) skips the normalization and returns the raw flash
triple in f32: ``acc (B, Hkv, G, Dv)``, the running max ``m (B, Hkv, G)``
and the denominator ``l (B, Hkv, G)``; a lane with no live position gives
``(0, -1e30, 0)``.  A tensor-parallel pool shard runs it over its own page
range and ``kernels.sharded.combine_stats`` merges the shards.  Each form
and flush counts launches under its own entry (``dispatch.KERNELS``):
``paged_attn``, ``paged_attn_win``, ``paged_attn_mla``, then ``_stats``
for K3 and ``_q`` for int8 pages.

On the card :func:`paged_attn` launches ``csrc/paged_attn.cu`` (whose
header says what bounds it and how the design answers that); on the CPU it
runs :func:`paged_attn_stats_plain`, the gathered math of the reference's
``_gathered_stats``, and :func:`paged_attn_plain` normalizes that.  The
GQA and MLA forms walk each lane's pages in order through a ring of
``cp.async`` stages in the first version's arithmetic, so they write its
bytes (``kernels/paged_attn_check.py`` holds the digests); their launch
plan (query heads, threads and pages a block's stage, stages) comes from
:func:`attn_plan`, from the shapes and the SM count alone.  The
window form splits each lane's table slots over ``S`` blocks
(:func:`window_splits`, from the shapes and the card's SM count alone: no
host sync), each block streaming its pages through a double-buffered
pipeline into its own f32 ``(acc, m, l)``, and a second kernel of the same
C entry merges the ``S`` partials in a fixed order and flushes either way;
one call still counts one launch.

Tables are ``(B, n_slots)`` int32 with sentinel ``P`` for unmapped slots;
lengths ``(B,)`` int32 live tokens per lane.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import SMEM_MAX

_NEG = -1e30  # finite -inf stand-in: keeps dead lanes exp()-safe
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_DTYPES = {**_DTYPES, torch.int8: 2}
_TAIL = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # scale, types, stream
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + _TAIL
_ARGTYPES_WIN = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + _TAIL
_ARGTYPES_MLA = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12 + _TAIL
# the limits of the GQA/MLA kernel's plan (csrc/paged_attn.cu: PA_*, which
# its launch checks): a warp owns up to ATTN_ITEMS (head, column slice)
# items of 32 * 4 columns (MLA) or 32 * 2 (GQA), a warp scores ATTN_ROWS
# (head, row) pairs at once where a warp scores a row (D + D2 >=
# ATTN_WARP_ROW_MIN), at most ATTN_MAX_THREADS threads a block, rings of 2
# to ATTN_MAX_STAGES stages
ATTN_ITEMS, ATTN_ROWS, ATTN_WARP_ROW_MIN = 4, 4, 256
# the fewest warps a block, where a thread (False) or a warp (True) scores a row
ATTN_MIN_WARPS = {False: 4, True: 8}
ATTN_MAX_THREADS, ATTN_MAX_STAGES = 512, 4
# pages a stage at most (of up to 32 rows; a page of more rows is a stage
# alone, a lane holding one of each 32 of its rows in ATTN_MAX_PAGES
# registers: ps <= ATTN_MAX_PS), and the pages the ring should hold
ATTN_MAX_PAGES, ATTN_RING_PAGES = 8, 4
ATTN_MAX_PS = 32 * ATTN_MAX_PAGES
# the window kernel: blocks of 32 * ceil(G / 2) threads, 8 columns a lane
# (csrc/paged_attn.cu)
WINDOW_MAX_G, WINDOW_MAX_D, WINDOW_VEC = 32, 256, 8
# the fewest table slots a block of the split window walk takes
WINDOW_MIN_SLOTS = 4
Stats = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class AttnPlan(NamedTuple):
    """The GQA/MLA kernel's launch plan: query ``heads`` a block,
    ``threads`` a block, ``pages`` a stage, ``stages`` in the ring."""

    heads: int
    threads: int
    pages: int
    stages: int


def paged_attn(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: Optional[torch.Tensor],
    tables: torch.Tensor, lengths: torch.Tensor, *, scale: float,
    window: int = 0, win_slots: int = 0,
    q2: Optional[torch.Tensor] = None, k2_pages: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
    k2_scale: Optional[torch.Tensor] = None, v_is_k: bool = False,
    emit_stats: bool = False,
) -> "torch.Tensor | Stats":
    """The normalized output, or with ``emit_stats`` the f32 triple
    ``(acc, m, l)`` (module docstring)."""
    kw = dict(scale=scale, window=window, win_slots=win_slots, q2=q2, k2_pages=k2_pages,
              k_scale=k_scale, v_scale=v_scale, k2_scale=k2_scale, v_is_k=v_is_k)
    ops = [t for t in (q, k_pages, v_pages, tables, lengths, q2, k2_pages, k_scale,
                       v_scale, k2_scale) if t is not None]
    if dispatch.on_card(*ops):
        return _launch(q, k_pages, v_pages, tables, lengths, emit_stats=emit_stats, **kw)
    plain = paged_attn_stats_plain if emit_stats else paged_attn_plain
    return plain(q, k_pages, v_pages, tables, lengths, **kw)


def _check(q, k_pages, v_pages, tables, lengths, window, win_slots, q2, k2_pages,
           k_scale, v_scale, k2_scale, v_is_k) -> bool:
    """Validate the operands; True for the MLA form."""
    mla = q2 is not None
    if mla != (k2_pages is not None) or mla != bool(v_is_k) or mla != (v_pages is None):
        raise ValueError("the MLA form takes q2, k2_pages and v_is_k=True (no v_pages) "
                         "together; the MHA/GQA form none of them")
    if window < 0 or bool(window) != bool(win_slots) or (window and win_slots != tables.shape[1]):
        raise ValueError(f"a window ({window}) takes win_slots equal to the table's "
                         f"{tables.shape[1]} slots, got {win_slots}")
    if window and mla:
        raise ValueError("the window option is not ported for the MLA form")
    b, hkv, g, d = q.shape
    if k_pages.dim() != 4 or k_pages.shape[2:] != (hkv, d):
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q {tuple(q.shape)}")
    if mla:
        if (q2.shape[:3] != q.shape[:3] or k2_pages.shape[:3] != k_pages.shape[:3]
                or k2_pages.shape[3] != q2.shape[3]):
            raise ValueError(f"q2 {tuple(q2.shape)} / k2_pages {tuple(k2_pages.shape)} "
                             f"do not match q {tuple(q.shape)} / pages {tuple(k_pages.shape)}")
    elif v_pages.dim() != 4 or v_pages.shape[:3] != k_pages.shape[:3]:
        raise ValueError(f"v pages {tuple(v_pages.shape)} do not match k pages "
                         f"{tuple(k_pages.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {b}")
    # int8 pages take one (P, ps) scale plane per page stream: K and K2 in
    # the MLA form (V is K), K and V otherwise
    given = {"k_scale": k_scale, "v_scale": v_scale, "k2_scale": k2_scale}
    wanted = ("k_scale", "k2_scale") if mla else ("k_scale", "v_scale")
    quant = k_pages.dtype == torch.int8
    if quant != any(s is not None for s in given.values()):
        raise ValueError("int8 pages take their scale planes, and only int8 pages take scales")
    if quant:
        if any((given[n] is None) != (n not in wanted) for n in given):
            raise ValueError(f"int8 pages of this form take exactly {wanted}, got "
                             f"{[n for n, s in given.items() if s is not None]}")
        for n in wanted:
            if given[n].shape != k_pages.shape[:2]:
                raise ValueError(f"{n} {tuple(given[n].shape)} is not the pages' (P, ps) "
                                 f"{tuple(k_pages.shape[:2])}")
    return mla


def _launch(q, k_pages, v_pages, tables, lengths, *, scale, window, win_slots, q2, k2_pages,
            k_scale, v_scale, k2_scale, v_is_k, emit_stats):
    mla = _check(q, k_pages, v_pages, tables, lengths, window, win_slots, q2, k2_pages,
                 k_scale, v_scale, k2_scale, v_is_k)
    queries = (q, q2) if mla else (q,)
    pages = (k_pages, k2_pages) if mla else (k_pages, v_pages)
    scales = tuple(s for s in (k_scale, v_scale, k2_scale) if s is not None)
    if (q.dtype not in _DTYPES or k_pages.dtype not in _PAGE_DTYPES
            or any(t.dtype != q.dtype for t in queries)
            or any(t.dtype != k_pages.dtype for t in pages)):
        raise TypeError(f"paged_attn kernel takes f32 or bf16 queries of one type and "
                        f"f32, bf16 or int8 pages of one type, got "
                        f"{[t.dtype for t in queries]} and {[t.dtype for t in pages]}")
    if any(s.dtype != torch.float16 for s in scales):
        raise TypeError(f"the kernel reads f16 scales, got {[s.dtype for s in scales]}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    if not all(t.is_contiguous() for t in queries + pages + scales + (tables, lengths)):
        raise ValueError("paged_attn kernel needs contiguous operands")
    b, hkv, g, d = q.shape
    n_pages, ps = k_pages.shape[:2]
    n_slots = tables.shape[1]
    d2 = q2.shape[-1] if mla else 0
    dv = d if mla else v_pages.shape[-1]
    if window:
        splits = window_splits(b, hkv, n_slots, sm_count(q.device))
        _check_window_shapes(g, d, dv, ps, bool(scales))
        smem = dispatch.kernel_fn("paged_attn", "paged_attn_win_smem_bytes",
                                  [ctypes.c_int] * 6)(d, dv, ps, n_slots, splits,
                                                      _PAGE_DTYPES[k_pages.dtype])
        limit = dispatch.kernel_fn("paged_attn", "paged_attn_smem_max", [])()
        if smem > limit:
            raise ValueError(f"G={g}, D={d}, Dv={dv}, ps={ps} need {smem} B of shared "
                             f"memory, over the block's {limit}")
    else:  # the plan fits SMEM_MAX; the launch refuses one that does not
        plan = attn_plan(b, hkv, g, d, d2, dv, ps, k_pages.element_size(), bool(scales), mla,
                         sm_count(q.device))
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((b, hkv, g, dv), **f32) if emit_stats else torch.empty(
        (b, hkv, g, dv), dtype=q.dtype, device=q.device)
    m, l = (torch.empty((b, hkv, g), **f32) for _ in range(2)) if emit_stats else (None, None)
    result = (out, m, l) if emit_stats else out
    if b == 0 or hkv == 0:
        return result
    types = (_DTYPES[q.dtype], _PAGE_DTYPES[k_pages.dtype], dispatch.stream_ptr(q.device))
    outs = (out.data_ptr(), _ptr(m), _ptr(l))
    if mla:
        fn = dispatch.kernel_fn("paged_attn", "paged_attn_mla_launch", _ARGTYPES_MLA)
        rc = fn(q.data_ptr(), q2.data_ptr(), k_pages.data_ptr(), k2_pages.data_ptr(),
                _ptr(k_scale), _ptr(k2_scale), tables.data_ptr(), lengths.data_ptr(),
                *outs, b, hkv, g, d, d2, n_pages, ps, n_slots, *plan, float(scale), *types)
    elif window:
        # the splits' partials: acc (S, B, Hkv, G, Dv), then m and l (S, B, Hkv, G)
        work = torch.empty(splits * b * hkv * g * (dv + 2), **f32) if splits > 1 else None
        fn = dispatch.kernel_fn("paged_attn", "paged_attn_win_launch", _ARGTYPES_WIN)
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), _ptr(k_scale),
                _ptr(v_scale), tables.data_ptr(), lengths.data_ptr(), *outs, _ptr(work),
                b, hkv, g, d, dv, n_pages, ps, n_slots, int(window), splits, float(scale),
                *types)
    else:
        fn = dispatch.kernel_fn("paged_attn", "paged_attn_launch", _ARGTYPES)
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), _ptr(k_scale),
                _ptr(v_scale), tables.data_ptr(), lengths.data_ptr(), *outs,
                b, hkv, g, d, dv, n_pages, ps, n_slots, *plan, float(scale), *types)
    name = entry(mla=mla, window=window, stats=emit_stats, quant=bool(scales))
    dispatch.check_launch(name, rc)
    if window:
        dispatch.last_splits[name] = splits
    return result


def window_splits(b: int, hkv: int, n_slots: int, sms: int) -> int:
    """Blocks ``S`` over which the window kernel splits each (lane, KV
    head)'s ``n_slots`` table slots, from the shapes alone (never the
    lengths, which live on the card): ``ceil(n_slots / c)``, ``c`` slots
    being at least :data:`WINDOW_MIN_SLOTS` and enough that the ``b * hkv``
    walks make about one block per SM (one wave: more blocks than SMs
    measured slower at RecurrentGemma's decode), so ``S = 1`` once ``b *
    hkv`` fills the ``sms`` SMs.  The kernel's blocks of ``ceil(n_slots /
    S)`` slots then cover the table in exactly ``S`` blocks, none empty."""
    return -(-n_slots // max(WINDOW_MIN_SLOTS, -(-n_slots * b * hkv // sms)))


def attn_smem_bytes(heads: int, threads: int, d: int, d2: int, dv: int, ps: int,
                    itemsize: int, quant: bool, mla: bool, pages: int, stages: int) -> int:
    """Bytes of shared memory the GQA/MLA kernel takes (``csrc/paged_attn.cu``:
    ``AttnSmem``): f32 queries, a stage's scores, its page records and
    each warp's probabilities and rescales, then ``stages`` stages of
    ``pages`` pages' raw rows, each row padded to an odd number of 16-byte
    units, and for int8 pages two f16 scale planes.  The plan is chosen
    with this count; the launch lays the same memory out and refuses a
    plan past ``SMEM_MAX``, so a count that fell short would fail the
    launch, never overflow the block."""
    def a16(n):
        return -(-n // 16) * 16

    def stride(nbytes):
        return 0 if nbytes == 0 else a16(nbytes) + (16 if a16(nbytes) // 16 % 2 == 0 else 0)

    rows = pages * ps
    stage = rows * (stride(d * itemsize) + stride(d2 * itemsize)
                    + (0 if mla else stride(dv * itemsize))) + (2 * a16(rows * 2) if quant else 0)
    head = a16(4 * (heads * (d + d2) + heads * rows + stages * (pages + 1)
                    + threads // 32 * (rows + ATTN_MAX_PAGES)))
    return head + stages * stage


def attn_plan(b: int, hkv: int, g: int, d: int, d2: int, dv: int, ps: int, itemsize: int,
              quant: bool, mla: bool, sms: int) -> AttnPlan:
    """The GQA/MLA kernel's launch plan, from the shapes and the card's SM
    count alone (never the lengths, which live on the card).

    - ``heads``: the fewest query heads a block (a divisor of ``g``) that
      keep the ``b * hkv * g / heads`` blocks within one wave of ``sms``
      (the pages of a KV head are then re-read per block, from L2), and
      at most what ``ATTN_MAX_THREADS / 32`` warps of ``ATTN_ITEMS``
      items hold.
    - ``threads``: enough warps for the items, at least 4 where a thread
      scores a row and 8 where a warp does (more warps hide more of the
      scores' latency).
    - ``pages``: enough pages a stage that every thread (a warp's
      ``ATTN_ROWS`` pairs where a warp scores a row) has a score to
      compute, up to ``ATTN_MAX_PAGES``; one for pages of more than 32
      rows.
    - ``stages``: a ring of about ``ATTN_RING_PAGES`` pages, at least 2,
      fewer stages (then fewer pages a stage, then one stage without a
      ring, then fewer heads a block) until the shared memory fits
      ``SMEM_MAX``.

    Raises ``ValueError`` for shapes the kernel does not take: ps over
    ``ATTN_MAX_PS``, a Dv wider than ``ATTN_MAX_THREADS / 32`` warps of
    items, or a page of one head that overflows the shared memory."""
    if ps > ATTN_MAX_PS:
        raise ValueError(f"the paged_attn kernel takes pages of at most {ATTN_MAX_PS} rows, "
                         f"got ps={ps}")
    slices = -(-dv // (32 * (4 if mla else 2)))  # a lane holds 4 (MLA) or 2 columns
    max_items = ATTN_MAX_THREADS // 32 * ATTN_ITEMS
    fit = [h for h in range(1, g + 1) if g % h == 0 and h * slices <= max_items]
    if not fit:
        raise ValueError(f"Dv={dv} is wider than the kernel's {max_items} column slices")
    first = next((h for h in fit if b * hkv * (g // h) <= sms), fit[-1])
    warp_rows = d + d2 >= ATTN_WARP_ROW_MIN
    for heads in [h for h in reversed(fit) if h <= first]:
        warps = max(ATTN_MIN_WARPS[warp_rows], -(-heads * slices // ATTN_ITEMS))
        pairs = warps * ATTN_ROWS if warp_rows else 32 * warps
        pages = 1 if ps > 32 else min(ATTN_MAX_PAGES, max(1, pairs // (heads * ps)))
        stages = min(ATTN_MAX_STAGES, max(2, -(-ATTN_RING_PAGES // pages)))
        while attn_smem_bytes(heads, 32 * warps, d, d2, dv, ps, itemsize, quant, mla, pages,
                              stages) > SMEM_MAX and stages:
            if stages > 2:
                stages -= 1
            elif pages > 1:
                pages -= 1
            else:  # no ring (one stage filled, used and refilled), then no plan
                stages -= 1
        if stages:
            return AttnPlan(heads, 32 * warps, pages, stages)
    raise ValueError(f"G={g}, D={d}, D2={d2}, Dv={dv}, ps={ps} need more than a block's "
                     f"{SMEM_MAX} B of shared memory")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (read once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_window_shapes(g, d, dv, ps, quant) -> None:
    """What the window kernel takes: G <= 32 query heads a KV head, D and
    Dv multiples of 8 (a lane reads 8 columns at once) up to 256, and for
    int8 pages an even ps (it stages a page's f16 scales in 4-byte words
    or wider)."""
    if g > WINDOW_MAX_G or max(d, dv) > WINDOW_MAX_D or d % WINDOW_VEC or dv % WINDOW_VEC:
        raise ValueError(f"the window kernel takes G <= {WINDOW_MAX_G} and D, Dv multiples "
                         f"of {WINDOW_VEC} up to {WINDOW_MAX_D}, got G={g}, D={d}, Dv={dv}")
    if quant and ps % 2:
        raise ValueError(f"the window kernel takes int8 pages of an even ps, got ps={ps}")


def entry(*, mla: bool, window: int, stats: bool, quant: bool) -> str:
    """The launch-count entry of one form: ``paged_attn[_mla|_win][_stats][_q]``."""
    return ("paged_attn" + ("_mla" if mla else "_win" if window else "")
            + ("_stats" if stats else "") + ("_q" if quant else ""))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def paged_attn_plain(q: torch.Tensor, *args, **kw) -> torch.Tensor:
    """The normalized function in plain PyTorch (the reference's
    ``paged_attn_xla``): :func:`paged_attn_stats_plain` divided through,
    cast to ``q.dtype``; dead lanes give exact zeros."""
    acc, _, l = paged_attn_stats_plain(q, *args, **kw)
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def paged_attn_stats_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: Optional[torch.Tensor],
    tables: torch.Tensor, lengths: torch.Tensor, *, scale: float,
    window: int = 0, win_slots: int = 0,
    q2: Optional[torch.Tensor] = None, k2_pages: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
    k2_scale: Optional[torch.Tensor] = None, v_is_k: bool = False,
) -> Stats:
    """The stats form in plain PyTorch, the reference's ``_gathered_stats``:
    gather every lane's table slots into a ``(B, n_slots·ps)`` view (int8
    pages dequantized, as ``src/repro/kernels/ref.py:_dequant_pages``),
    apply the per-position masks and return the f32 ``(acc, m, l)`` of one
    softmax over it."""
    mla = _check(q, k_pages, v_pages, tables, lengths, window, win_slots, q2, k2_pages,
                 k_scale, v_scale, k2_scale, v_is_k)
    n_pages, ps = k_pages.shape[:2]
    lens = lengths.long()[:, None]  # (B, 1)
    slot = torch.arange(tables.shape[1], device=q.device)[None, :]  # (1, S)
    if window:
        # slot p holds the newest logical page pg ≡ p (mod win_slots) at or
        # before the current page (torch's % on a positive divisor is a
        # floor modulo, as jnp.mod)
        cur = (lens - 1).clamp(min=0) // ps
        pg = cur - (cur - slot) % win_slots
        lo = (lens - window).clamp(min=0)
    else:
        pg, lo = slot.expand(tables.shape[0], -1), torch.zeros_like(lens)
    apos = pg[..., None] * ps + torch.arange(ps, device=q.device)  # (B, S, ps)
    valid = ((apos < lens[..., None]) & (apos >= lo[..., None])
             & (tables[..., None] != n_pages) & (pg[..., None] >= 0))  # (B, S, ps)
    phys = tables.long().clamp(0, n_pages - 1)  # sentinel rows are masked

    def gather(pages, sc):  # (B, S, ps, Hkv, D) f32
        rows = pages[phys].float()
        return rows if sc is None else rows * sc[phys].float()[..., None, None]

    kg = gather(k_pages, k_scale)
    s = torch.einsum("bhgd,bsphd->bhgsp", q.float(), kg)
    if mla:
        s = s + torch.einsum("bhgd,bsphd->bhgsp", q2.float(), gather(k2_pages, k2_scale))
    s = torch.where(valid[:, None, None], s * scale, _NEG)
    m = s.amax(dim=(-2, -1))  # _NEG on dead lanes
    pexp = torch.exp(s - m[..., None, None]) * valid[:, None, None]
    l = pexp.sum(dim=(-2, -1))
    acc = torch.einsum("bhgsp,bsphd->bhgd", pexp, kg if mla else gather(v_pages, v_scale))
    return acc, m, l
