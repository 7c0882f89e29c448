"""KV-cache layouts (counterpart of ``repro/models/cache.py``).

- :class:`SlabLayout`: a contiguous ``(..., B, max_len, ...)`` slab; a
  sliding-window layer whose window fits in ``max_len`` keeps a rolling
  ``(..., B, window, ...)`` slab instead, oldest position first, rolled by
  one row per lane once the lane's position reaches the window.
- :class:`PagedLayout`: a ``(..., P + 1, ps, ...)`` pool behind per-lane
  page tables, int32; unmapped slots hold the sentinel ``P``.  The
  ``"full"`` table is append-only, ``ceil(max_len / ps)`` slots (slot ``p``
  holds positions ``[p·ps, (p+1)·ps)``); sliding-window layers read the
  modular ``"win"`` table of ``pages_win = ceil((window + lookahead - 1) /
  ps) + 1`` slots, where position ``pos`` lives in slot ``(pos // ps) %
  pages_win`` and the host pool evicts the pages the window has slid past
  (``serving.kv_pool``).  ``lookahead`` (the engine's steps per dispatch)
  leaves room to map every page a dispatch writes without reusing the slot
  of a page still in some step's window.  A layer is windowed iff its
  window is at most ``max_len``, the same condition under which the slab
  rolls; otherwise it pages like full attention.

A layer's cache entry is a dict of leaves, each with its own per-token
shape: ``{"k", "v"}`` of ``(Hkv, D)`` for attention, ``{"ckv", "krope"}`` of
``(kv_lora,)`` / ``(rope_dim,)`` for MLA's latents.  Leading axes stack
layers (``(L, ...)`` under ``body``; none for a ``head_*`` layer).  The
layouts treat every leaf alike: ``alloc`` is the reference's
``attn_alloc``/``mla_alloc``, ``write`` (one token per lane into one
layer's entry) its ``attn_write``/``mla_write``, ``write_rows`` (prefilled
rows into a stacked entry) its ``attn_write_rows``/``mla_write_rows``,
``write_chunk`` (one prompt chunk per lane into one layer's entry) its
``attn_write_chunk``/``mla_write_chunk``, and ``chunk_view`` (the whole
logical view of some lanes) and ``chunk_view_win`` (a chunk's reach
through the window table) its ``attn_chunk_view``/``mla_chunk_view`` and
``attn_chunk_view_win``.  MLA's expanded decode runs on the slab only and
reads the slab itself; on the pool MLA decodes through the kernel.

The JAX package leans on out-of-range scatters being dropped: writes of idle
lanes, pad rows and frozen lanes aim at the sentinel page ``P`` and vanish.
PyTorch raises on such an index, so the paged pool carries one extra page at
index ``P`` that absorbs those writes; decode never reads it (the kernel and
the plain attention see only pages ``[0, P)``), and a chunk view reads it
only at slots its causal mask hides.  Slab writes past the slab's end are
masked per lane instead.

Int8 pages (``PagedLayout.quant``, the reference's ``quant``): every pool
leaf stores int8 codes beside a ``<leaf>_scale`` plane of ``lead + (P + 1,
ps)`` f16 scales, one per (page, slot), sink page included.  A token's scale
is the absmax over all its per-token dims (every KV head together) over
127, floored at ``_QEPS`` and rounded through f16 before the divide, so
the codes divide by exactly the scale every reader multiplies back
(:func:`quant` / :func:`dequant`).  Writes quantize on the way in; prefill
attention still reads the fresh fp K/V, and a decode step reads the codes
it has just written, so the current token is seen int8-rounded, as in the
reference.

Tensor-parallel pools (``PagedLayout.shards`` > 1, the reference's
``shards``): the pages axis is split over the mesh's model axis, so the
rank at model index ``shard`` holds global pages ``[shard·P/S,
(shard+1)·P/S)`` as local pages ``[0, P/S)`` plus its own sink page
``P/S``, which is also the local sentinel ``kernels.sharded.
shard_local_tables`` gives every page the rank does not hold.  Tables keep
global ids and are replicated; a write whose page lives on another rank
lands on the local sink.

Tensor-parallel slabs (``SlabLayout.shards`` > 1, the reference's
``cache_pspecs`` with ``kv_shard="seq"``): each lane's rows are split over
the mesh's model axis, the rank at model index ``shard`` holding global
rows ``[shard·per, (shard+1)·per)`` with ``per = rows / S``.  A layer
whose rows the ranks do not divide is whole on every rank
(:meth:`SlabLayout.split` is 1), as the reference's sanitized placement
holds it, and is written and read as on one rank.  A write lands only
on the rank that holds its row.  A split window slab does not roll, since
a roll would move one row per lane across every rank boundary each step:
it is a ring, position ``pos`` in row ``pos % rows``, which holds the
same positions as the rolled slab in another order (attention sums over
them in any order).  The unsplit slab keeps the roll, though it copies
the window each step: its rows are the reference's, row for row (the
parity tests hold the two caches leaf for leaf), and on one rank the
ring's other order would also change the order of attention's f32 sums.
Over a data axis a rank's slab (and a pool's per-lane leaves) hold only
its data row's lanes, lane ``i`` at row ``i - lo``
(``compressed_pspecs.lane_range``); the layouts see local lanes only, and
a pool's page tables keep a row for every lane of the mesh.
Attention's decode reads a rank's rows through
``layers.decode_attention_stats`` and combines the ranks' flash triples
(``kernels.sharded.combine_stats``); MLA's does the same over its latent
rows in the absorbed form (``models.mla``).

Writes update the cache tensors in place.  RG-LRU and SSM states are per
lane under both layouts and do not pass through here (``models.model``);
an arch without attention or MLA layers gets a layout with no table.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.sharded import shard_local_tables

# the int8 scale's floor: keeps all-zero tokens from dividing by zero, and
# survives the f16 round trip as a normal number
_QEPS = 1e-4


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def quant(x: torch.Tensor, lead: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Int8 codes and f16 scales of ``x``, one scale per index of its first
    ``lead`` dims (a token): the absmax over the rest / 127, floored at
    ``_QEPS`` and rounded through f16 before the divide; codes round half to
    even."""
    xf = x.float()
    scale = (xf.abs().amax(dim=tuple(range(lead, x.dim()))) / 127.0).clamp_min(_QEPS)
    scale = scale.half().float()
    q = torch.round(xf / scale.reshape(scale.shape + (1,) * (x.dim() - lead)))
    return q.to(torch.int8), scale.half()


def dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Codes times their per-token scales, in f32."""
    return q.float() * scale.float().reshape(scale.shape + (1,) * (q.dim() - scale.dim()))


@dataclasses.dataclass(frozen=True)
class SlabLayout:
    """Contiguous ``(B, max_len, ...)`` per-lane cache; with ``shards`` > 1
    this rank's range of every lane's rows (module docstring)."""

    max_len: int = 0  # only needed for allocation
    shards: int = 1  # model-axis ranks each lane's rows are split over
    shard: int = 0  # this rank's model index
    kind = "slab"

    def rows(self, window=None) -> int:
        """A layer's rows a lane: ``max_len``, or ``min(max_len, window)``
        for a sliding-window layer."""
        return self.max_len if window is None else min(self.max_len, window)

    def split(self, window=None) -> int:
        """The ranks a layer's rows are split over: ``shards`` where they
        divide :meth:`rows`, else 1 (the layer whole on every rank)."""
        return self.shards if self.rows(window) % self.shards == 0 else 1

    def _ring(self, window) -> bool:
        """A split window slab whose window fits ``max_len`` is a ring."""
        return self.split(window) > 1 and window is not None and window <= self.max_len

    def alloc(self, lead: tuple, batch: int, entries: dict, dtype, device,
              window=None) -> dict:
        """Zeroed ``lead + (B, S) + shape`` leaves, one per ``entries`` name
        -> per-token shape; ``S`` is :meth:`rows`, or this rank's
        ``rows / split`` of them."""
        s = self.rows(window) // self.split(window)
        return {name: torch.zeros(lead + (batch, s) + shp, dtype=dtype, device=device)
                for name, shp in entries.items()}

    def tables(self, batch: int, device):
        return None

    def valid_rows(self, pos: torch.Tensor, per: int, window=None) -> torch.Tensor:
        """``(B, per)`` bool: which of this rank's ``per`` rows a decode step
        at ``pos`` attends over, its row ``i`` being global row ``shard·per
        + i``: the first ``min(pos + 1, rows)`` global rows (positions, or
        ring slots once a window ring has filled); every row of a layer
        whole on the rank."""
        first = self.shard * per if self.split(window) > 1 else 0
        j = first + torch.arange(per, device=pos.device)
        live = torch.minimum(pos.long() + 1, torch.full_like(pos.long(), self.rows(window)))
        return j[None, :] < live[:, None]

    def _write_split(self, c: dict, entries: dict, pos, window, commit) -> None:
        """:meth:`write` on a split slab: the rank holding the token's row
        (its position, or ``pos % rows`` on a window ring) stores it; a lane
        at ``pos >= rows`` is frozen (append-only) or, on the ring, outside
        ``commit`` keeps the live row it would overwrite."""
        s, bidx = self.rows(window), torch.arange(pos.shape[0], device=pos.device)
        ring, pos = self._ring(window), pos.long()
        for name, x in entries.items():
            per = c[name].shape[1]
            local = (pos % s if ring else pos) - self.shard * per
            ok = (local >= 0) & (local < per)
            if not ring:
                ok = ok & (pos < s)
            elif commit is not None:
                ok = ok & ((pos < s) | commit)
            slot = local.clamp(0, per - 1)
            old = c[name][bidx, slot]
            keep = ok.reshape((-1,) + (1,) * (old.dim() - 1))
            c[name][bidx, slot] = torch.where(keep, x.to(old.dtype), old)

    def _write_rows_split(self, c: dict, rows: dict, lanes, lens, window) -> None:
        """:meth:`write_rows` on a split slab: this rank's rows of each
        lane, positions in order (pad entries included, as unsplit), or on
        a window ring each slot's newest position below ``lens``."""
        s = self.rows(window)
        for name, x in rows.items():
            per, lp = c[name].shape[2], x.shape[2]
            lo = self.shard * per
            if not self._ring(window):
                hi = min(lo + per, lp, s)
                if hi > lo:
                    c[name][:, lanes, : hi - lo] = x[:, :, lo:hi].to(c[name].dtype)
                continue
            n = min(per, s - lo)
            if n <= 0:
                continue
            j = lo + torch.arange(n, device=lens.device)
            last = lens.long()[:, None] - 1
            p = (last - torch.remainder(last - j, s)).clamp(0, lp - 1)  # (N, n)
            lane = torch.arange(x.shape[1], device=lens.device)[:, None]
            c[name][:, lanes, :n] = x[:, lane, p].to(c[name].dtype)

    def write(self, c: dict, entries: dict, pos, tables, window=None, commit=None) -> None:
        """Write one token per lane at ``pos`` into one layer's ``c``
        (leaves ``(B, S, ...)``).  A rolling window slab (``window <= S``)
        first rolls the lanes at ``pos >= S`` back by one row and writes
        them at row ``S - 1``; otherwise lanes at ``pos >= S`` (frozen at
        capacity) keep their contents, as the reference's dropped scatter
        does.  Lanes outside ``commit`` ((B,) bool, optional) at ``pos >=
        S`` of a rolling slab neither roll nor write: that row is live."""
        if self.split(window) > 1:
            return self._write_split(c, entries, pos, window, commit)
        bidx = torch.arange(pos.shape[0], device=pos.device)
        for name, x in entries.items():
            s = c[name].shape[1]
            slot = pos.clamp(max=s - 1)
            if window is not None and window <= s:
                full = pos >= s
                if commit is not None:
                    full = full & commit
                    keep = (~commit & (pos >= s)).reshape((-1,) + (1,) * (x.dim() - 1))
                    x = torch.where(keep, c[name][bidx, slot], x.to(c[name].dtype))
                full = full.reshape((-1,) + (1,) * (c[name].dim() - 1))
                c[name].copy_(torch.where(full, torch.roll(c[name], -1, dims=1), c[name]))
                c[name][bidx, slot] = x.to(c[name].dtype)
                continue
            old = c[name][bidx, slot]
            ok = (pos < s).reshape((-1,) + (1,) * (old.dim() - 1))
            c[name][bidx, slot] = torch.where(ok, x.to(old.dtype), old)

    def write_rows(self, c: dict, rows: dict, lanes, lens, tables, window=None) -> None:
        """Write prefilled rows ``(L, N, Lp, ...)`` into lanes ``lanes``
        (distinct, all real) of the stacked cache.  Positions ``>= lens``
        get the prompt's pad entries: dead under the length mask, and
        overwritten by later decode writes.  A window slab shorter than the
        rows keeps each row's last ``min(lens, S)`` positions, oldest
        first (the rolled order)."""
        if self.split(window) > 1:
            return self._write_rows_split(c, rows, lanes, lens, window)
        for name, x in rows.items():
            s, lp = c[name].shape[2], x.shape[2]
            if s < lp:
                idx = ((lens.long() - s).clamp(min=0)[:, None]
                       + torch.arange(s, device=lens.device)).clamp(max=lp - 1)
                x = x[:, torch.arange(x.shape[1], device=lens.device)[:, None], idx]
            c[name][:, lanes, : min(s, lp)] = x.to(c[name].dtype)

    def write_chunk(self, c: dict, rows: dict, lanes, starts, lengths, tables,
                    window=None) -> None:
        """Write one prompt chunk per row into one layer's ``c`` (leaves
        ``(B, S, ...)``): row ``r``'s entries ``i < lengths[r]`` (``rows``
        ``(R, C, ...)``) land at positions ``starts[r] + i`` of lane
        ``lanes[r]``; a lane ``>= B`` marks a pad row.  Pad entries rewrite
        the last row ``S - 1`` of their (clamped) lane with its own
        contents: no chunk writes there, since a prompt is shorter than the
        slab.  Only append-only slabs chunk (the engine keeps windowed
        archs off the slab's chunked path), and only unsplit ones."""
        self._unsplit("chunked prefill")
        b, s = next(iter(c.values())).shape[:2]
        i = torch.arange(next(iter(rows.values())).shape[1], device=lanes.device)
        lane = lanes.long().clamp(max=b - 1)[:, None]
        valid = (i < lengths[:, None]) & (lanes < b)[:, None]  # (R, C)
        slot = torch.where(valid, starts.long()[:, None] + i, s - 1)
        for name, x in rows.items():
            old = c[name][lane, slot]
            keep = valid.reshape(valid.shape + (1,) * (x.dim() - 2))
            c[name][lane, slot] = torch.where(keep, x.to(old.dtype), old)

    def chunk_view(self, c: dict, lanes, tables) -> dict:
        """Each leaf's ``(R, S, ...)`` rows of lanes ``lanes`` (a pad row's
        lane clamped: garbage its caller discards)."""
        self._unsplit("a chunk view")
        take = lanes.long().clamp(max=next(iter(c.values())).shape[0] - 1)
        return {name: x[take] for name, x in c.items()}

    def _unsplit(self, what: str) -> None:
        if self.shards > 1:
            raise NotImplementedError(f"{what} over a split slab is not ported yet (the rest "
                                      "of tensor parallelism, ROADMAP.md)")


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Block-granular pool behind append-only and modular page tables."""

    page_size: int
    num_pages: int
    max_len: int
    win: int = 0  # min(max_len, local_window) when the arch has windowed layers
    has_full: bool = True  # any non-windowed attention or MLA layer
    lookahead: int = 1  # decode steps one dispatch may take (pages mapped ahead)
    quant: bool = False  # int8 codes + per-(page, slot) f16 scale planes
    shards: int = 1  # model-axis ranks the pages axis is split over
    shard: int = 0  # this rank's model index
    kind = "paged"

    @property
    def pages_full(self) -> int:
        return cdiv(self.max_len, self.page_size) if self.has_full else 0

    @property
    def pages_win(self) -> int:
        if not self.win:
            return 0
        return cdiv(self.win + max(self.lookahead, 1) - 1, self.page_size) + 1

    @property
    def sentinel(self) -> int:
        """The tables' id for an unmapped slot (global, replicated)."""
        return self.num_pages

    @property
    def local_pages(self) -> int:
        """Pages this rank holds (``P/S``); its sink page is the next one."""
        return self.num_pages // self.shards

    def _local(self, phys: torch.Tensor) -> torch.Tensor:
        """Global page ids -> this rank's pages, foreign pages and the
        sentinel to the sink ``local_pages`` (the read path's remap)."""
        if self.shards == 1:
            return phys
        return shard_local_tables(phys, self.shard, self.local_pages)[0]

    def _windowed(self, window) -> bool:
        return window is not None and window <= self.max_len

    def table_key(self, window) -> str:
        """The table a layer with this window reads."""
        return "win" if self._windowed(window) else "full"

    def view_window(self, window) -> int:
        """The live window width a kernel masks to (0 = append-only)."""
        return min(self.max_len, window) if self._windowed(window) else 0

    def alloc(self, lead: tuple, batch: int, entries: dict, dtype, device,
              window=None) -> dict:
        """Zeroed ``lead + (P/S + 1, ps) + shape`` pools (the last page is
        the sink), one per ``entries`` name -> per-token shape; under
        ``quant`` int8 pools and a ``<name>_scale`` plane ``lead + (P/S + 1,
        ps)`` of f16 beside each."""
        pool = (self.local_pages + 1, self.page_size)
        if not self.quant:
            return {name: torch.zeros(lead + pool + shp, dtype=dtype, device=device)
                    for name, shp in entries.items()}
        out = {}
        for name, shp in entries.items():
            out[name] = torch.zeros(lead + pool + shp, dtype=torch.int8, device=device)
            out[name + "_scale"] = torch.zeros(lead + pool, dtype=torch.float16, device=device)
        return out

    def tables(self, batch: int, device) -> dict:
        return {key: torch.full((batch, n), self.sentinel, dtype=torch.int32, device=device)
                for key, n in (("full", self.pages_full), ("win", self.pages_win)) if n}

    def pool_view(self, pages: torch.Tensor) -> torch.Tensor:
        """The ``(P/S, ps, ...)`` pages (or ``(P/S, ps)`` scales) attention
        reads: the sink page cut."""
        return pages[: self.local_pages]

    def _scatter(self, c: dict, entries: dict, widx: torch.Tensor, lead: int) -> None:
        """Store ``entries`` (``lead`` layer axes, then one token per
        ``widx``) at the pool's flat ``(page, slot)`` indices ``widx``;
        under ``quant`` each token's codes, and its scale into the
        ``<name>_scale`` plane at the same index."""
        at = (slice(None),) * lead + (widx,)
        for name, x in entries.items():
            pool = c[name]
            flat = pool.view(pool.shape[:lead] + (-1,) + pool.shape[lead + 2:])
            if self.quant:
                x, s = quant(x, lead + 1)
                sc = c[name + "_scale"]
                sc.view(sc.shape[:lead] + (-1,))[at] = s
            flat[at] = x.to(flat.dtype)

    def copy_pages(self, c: dict, src: torch.Tensor, dst: torch.Tensor, lead: int) -> None:
        """Copy pages ``src`` over pages ``dst`` (global ids, one pair per
        entry) in every pool of one layer's ``c``, codes and ``*_scale``
        planes alike, in place: the tensors keep their addresses."""
        for pool in c.values():
            pool.index_copy_(lead, dst, pool.index_select(lead, src))

    def write(self, c: dict, entries: dict, pos, tables, window=None, commit=None) -> None:
        """Scatter one token per lane into its page of one layer's pool
        ``(P + 1, ps, ...)``, through the window table's slot ``(pos // ps)
        % pages_win`` for a windowed layer; unmapped slots and positions
        past the full table land on the sink page.  ``commit`` is accepted
        for the slab's sake: a page write at ``pos`` is never read before
        the lane's next write there."""
        ps, page = self.page_size, pos.long() // self.page_size
        if self._windowed(window):
            phys = tables["win"].gather(1, (page % self.pages_win)[:, None])[:, 0]
        else:
            pt = tables["full"]
            phys = pt.gather(1, page.clamp(max=pt.shape[1] - 1)[:, None])[:, 0]
            phys = torch.where(page < pt.shape[1], phys, self.sentinel)
        self._scatter(c, entries, self._local(phys.long()) * ps + pos.long() % ps, 0)

    def write_rows(self, c: dict, rows: dict, lanes, lens, tables, window=None) -> None:
        """Scatter prefilled rows ``(L, N, Lp, ...)`` of lanes ``lanes``
        into the stacked pool; positions ``>= lens`` go to the sink page,
        and so do a windowed layer's positions below ``lens - win``."""
        ps = self.page_size
        lp = next(iter(rows.values())).shape[2]
        a = torch.arange(lp, device=lens.device)[None, :]
        valid = a < lens[:, None]
        if self._windowed(window):
            valid = valid & (a >= (lens[:, None] - self.view_window(window)))
            phys = tables["win"][lanes.long()][:, (a[0] // ps) % self.pages_win]
        else:
            phys = tables["full"][lanes.long()][:, a[0] // ps]
        widx = torch.where(valid, self._local(phys.long()) * ps + a % ps,
                           self.local_pages * ps).reshape(-1)
        self._scatter(c, {name: x.flatten(1, 2) for name, x in rows.items()}, widx, 1)

    # -- chunked prefill: one prompt chunk per row, batched over lanes --------
    #
    # Append-only layers chunk through the full table, whose pages for the
    # whole prompt were mapped at admission; windowed layers through the
    # window table, whose pages the engine maps chunk by chunk
    # (``ensure_steps(lane, start, csz)``, which also evicts the pages the
    # window slid past), so a chunk needs only the ``win + csz - 1``
    # positions :meth:`chunk_view_win` gathers.  Pad entries (``i >=
    # lengths[r]``) and pad rows (a lane ``>= B``) land on the sink page.

    def _table_rows(self, table: torch.Tensor, lanes) -> tuple[torch.Tensor, torch.Tensor]:
        """Each row's table row (a pad row's lane clamped) and whether the
        row is real."""
        b = table.shape[0]
        return table[lanes.long().clamp(max=b - 1)], lanes < b

    def write_chunk(self, c: dict, rows: dict, lanes, starts, lengths, tables,
                    window=None) -> None:
        """Scatter one prompt chunk per row into one layer's pool: row
        ``r``'s entries ``i < lengths[r]`` (``rows`` ``(R, C, ...)``) at
        positions ``starts[r] + i`` of lane ``lanes[r]``; under ``quant``
        quantized, with their scales at the same index."""
        ps = self.page_size
        csz = next(iter(rows.values())).shape[1]
        i = torch.arange(csz, device=lanes.device)
        pos = starts.long()[:, None] + i  # (R, C)
        if self._windowed(window):
            trow, real = self._table_rows(tables["win"], lanes)
            slot = (pos // ps) % self.pages_win
        else:
            trow, real = self._table_rows(tables["full"], lanes)
            slot = (pos // ps).clamp(max=self.pages_full - 1)
        phys = trow.gather(1, slot).long()
        valid = (i < lengths[:, None]) & real[:, None]
        widx = torch.where(valid, self._local(phys) * ps + pos % ps, self.local_pages * ps)
        self._scatter(c, {name: x.flatten(0, 1) for name, x in rows.items()},
                      widx.reshape(-1), 0)

    def _gather_leaves(self, c: dict, idx: torch.Tensor) -> dict:
        """Each K/V leaf of one layer's pool at flat ``(page, slot)`` indices
        ``idx`` ``(R, S)``, dequantized to f32 under ``quant``."""
        out = {}
        for name, pool in c.items():
            if name.endswith("_scale"):
                continue
            v = pool.view((-1,) + pool.shape[2:])[idx]
            if self.quant:
                v = dequant(v, c[name + "_scale"].view(-1)[idx])
            out[name] = v
        return out

    def chunk_view(self, c: dict, lanes, tables) -> dict:
        """The ``(R, pages_full·ps, ...)`` logical view of each row's lane
        through the full table: unmapped slots read the sink page, garbage
        that the causal mask hides from every real query."""
        ps = self.page_size
        a = torch.arange(self.pages_full * ps, device=lanes.device)
        trow, _ = self._table_rows(tables["full"], lanes)
        phys = self._local(trow[:, a // ps].long())
        return self._gather_leaves(c, phys * ps + a % ps)

    def chunk_view_win(self, c: dict, lanes, starts, csz: int, window, tables) -> dict:
        """The window table's view of each row's positions ``[starts - win +
        1, starts + csz - 1]`` (``win + csz - 1`` slots): all that the
        chunk's queries can reach under a ``win``-wide window.  Slots below
        position 0 read the sink page; the caller masks them
        (``chunked_attention``'s ``kv_valid_from``)."""
        ps, win = self.page_size, self.view_window(window)
        a = (starts.long() - win + 1)[:, None] + torch.arange(win + csz - 1,
                                                               device=lanes.device)
        an = a.clamp(min=0)
        trow, real = self._table_rows(tables["win"], lanes)
        phys = self._local(trow.gather(1, (an // ps) % self.pages_win).long())
        valid = (a >= 0) & real[:, None]
        return self._gather_leaves(c, torch.where(valid, phys * ps + an % ps,
                                                  self.local_pages * ps))


def paged_layout_for(cfg, max_len: int, *, page_size: int, num_pages: int,
                     lookahead: int = 1, quant: bool = False, shards: int = 1,
                     shard: int = 0) -> PagedLayout:
    """The layout an arch needs at a given logical capacity: attention
    layers are windowed iff ``local_window <= max_len``; the full table
    serves the others and MLA.  ``lookahead`` is the engine's steps per
    dispatch (it sizes the window table); ``quant`` stores int8 pages;
    ``shards``/``shard`` split the pages axis over a model axis."""
    if shards < 1 or num_pages % shards or not 0 <= shard < shards:
        raise ValueError(f"num_pages={num_pages} does not split over the {shards} ranks of "
                         f"the model axis (rank {shard})")
    from repro_torch.models.model import _block_mixer_mlp, _groups, layer_plan

    mixers = {_block_mixer_mlp(kind, cfg)[0] for _, kind, _ in _groups(layer_plan(cfg))}
    windowed = ("attn" in mixers and cfg.local_window is not None
                and cfg.local_window <= max_len)
    return PagedLayout(
        page_size=page_size, num_pages=num_pages, max_len=max_len,
        win=min(max_len, cfg.local_window) if windowed else 0,
        has_full="mla" in mixers or ("attn" in mixers and not windowed),
        lookahead=max(1, lookahead), quant=quant, shards=shards, shard=shard)
