"""Host-side paged KV pool (counterpart of ``repro/serving/kv_pool.py``).

``PagedKVPool`` owns the device cache (one ``(..., P + 1, ps, ...)`` pool per
cache leaf of each attention or MLA layer stack, see
``models.cache.PagedLayout``; every layer reads the same page tables, and
RG-LRU and SSM states stay per lane; with ``quant`` int8 pools and their
``<leaf>_scale`` planes), the free-page list with per-page refcounts,
and the per-lane page tables.  Two tables exist, as the architecture
needs (none for an arch without attention, such as Mamba-2: its pool holds
no page, every request needs none, and its cache is the per-lane states,
the reference's "ssm-only paged archs have no table'd layers"):

- ``full``: append-only, ``ceil(max_len / ps)`` slots per lane, for
  attention without a window and for MLA;
- ``win``: modular, ``pages_win`` slots per lane, for sliding-window
  layers.  Position ``pos`` lives in slot ``(pos // ps) % pages_win``; once
  the window has slid wholly past a page, the page is evicted (returned to
  the free list, counted in ``evicted_pages``) and its slot reused.

The tables are mirrored host-side in numpy and synced to the device
incrementally: mutations mark their lane dirty, and ``device_tables``
copies only dirty rows into the resident device tables.

The engine asks ``can_admit``/``alloc_prefill`` at admission,
``ensure_steps(lane, pos, k)`` before every decode dispatch (reserving all K
writes, so a dispatch never runs out of pages midway; ``lookahead``, the
engine's steps per dispatch, sizes the window table so those pages never
take the slot of a page still in the window) and ``release`` on finish or
preemption; after a speculative round, ``rollback`` drops the lane's
pages past its committed length.  The device tables are updated in place,
so unlike the reference there is no donated buffer to re-adopt.

Shared pages (prefix caching, the reference's): pages are refcounted.
``_take`` hands a page out at 1, ``add_ref``/``decref`` move the count,
and a page returns to the free list at 0, so ``release`` is a decref of
the lane's pages and a page the prefix index (``serving.prefix_cache``)
or another lane still holds stays resident.  ``alloc_prefill(...,
shared_full=, shared_len=)`` maps cached prefix pages into a lane's full
table.  No write lands in a page another holder can read: a write path
about to touch a page of refcount > 1 (a shared partial page at
admission, a decode write into a page the index pinned) first points the
lane at a fresh page (``_cow_full``) and queues the ``(src, dst)`` pair
in ``pending_copies``, the source pinned until ``apply_pending`` copies
the rows, in place, before the next forward or dispatch.

Staged admissions (the device scheduler's on-device refill, the
reference's ``stage_alloc``/``release_staged``/``adopt_staged``): the host
reserves fresh pages for a queued request's first writes and builds its
table rows without touching any lane; the decode loop copies a staged row
over a dead lane's row when it refills it, and the host's replay of that
refill adopts the row as the lane's (``adopt_staged``); a stage the loop
did not consume goes back (``release_staged``).  Its exposure, the
positions the refilled lane can write before the host next reconciles,
is capped by the engine's write horizon, which ``lookahead`` covers.

A pool on a mesh (``mesh=``, one ``launch.mesh.Mesh`` rank's view) splits
its pages axis over the model axis (the reference's ``kv_shard="seq"``,
``PagedLayout.shards``): ``num_pages`` must divide by the ranks, and each
rank allocates only its ``P/S`` pages plus a sink.  Page ids stay global:
the host allocator runs identically on every rank, so every rank keeps
the same tables.  The per-lane states follow the placements too: an SSM
state holds the rank's heads, RG-LRU states are whole on every rank
(``models.model.init_cache``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.cache import PagedLayout, cdiv, paged_layout_for
from repro_torch.models.model import copy_pages, init_cache


class PagedKVPool:
    def __init__(self, cfg, *, max_batch: int, max_len: int, num_pages: int,
                 page_size: int = 16, lookahead: int = 1, quant: bool = False,
                 device="cuda", mesh=None):
        shards = mesh.model if mesh is not None else 1
        self.mesh = mesh
        self.layout: PagedLayout = paged_layout_for(
            cfg, max_len, page_size=page_size, num_pages=num_pages, lookahead=lookahead,
            quant=quant, shards=shards, shard=mesh.model_index if mesh is not None else 0)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.cache = init_cache(cfg, max_batch, max_len, layout=self.layout, device=device)
        lo = self.layout
        self._pt = {"full": np.full((max_batch, lo.pages_full), lo.sentinel, np.int32),
                    "win": np.full((max_batch, lo.pages_win), lo.sentinel, np.int32)}
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        # 0 = free, 1 = held once, > 1 = shared (lanes, the prefix index, a copy pin)
        self._ref = np.zeros(num_pages, np.int32)
        # per lane and table: logical page number -> page id
        self._pages = {key: [dict() for _ in range(max_batch)] for key in self._pt}
        self._dirty: set[int] = set(range(max_batch))
        self._synced = False
        # (src, dst) page pairs whose rows apply_pending has still to copy;
        # each src holds one extra reference until then
        self.pending_copies: list[tuple[int, int]] = []
        self.cow_copies = 0  # copy-on-write forks
        self.evicted_pages = 0  # window pages freed as the window slid past them
        self.table_full_uploads = 0  # whole-table device uploads
        self.table_row_syncs = 0  # dirty rows copied incrementally
        self.table_syncs = 0  # device_tables calls that moved any data

    # -- accounting ----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.layout.num_pages - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages held by more than one reference."""
        return int((self._ref > 1).sum())

    def lane_pages(self, lane: int) -> list[int]:
        """The page ids one lane holds: its full table's, then its window
        table's."""
        return [pid for key in ("full", "win") for pid in self._pages[key][lane].values()]

    def _win_span_pages(self, length: int) -> int:
        """Distinct pages covering the live window of a length-``length``
        sequence."""
        if not self.layout.win or length <= 0:
            return 0
        ps = self.layout.page_size
        return (length - 1) // ps - max(0, length - self.layout.win) // ps + 1

    def prefill_pages(self, prompt_len: int) -> int:
        """Pages a prompt needs through its first decode write at position
        ``prompt_len`` (reserved up front, so a freshly prefilled lane is
        never preempted by its first ``ensure_steps``): the whole prompt in
        the full table, its live window span in the window table, plus the
        page the first write opens in each."""
        ps, lo = self.layout.page_size, self.layout
        boundary = 1 if prompt_len % ps == 0 else 0
        full = cdiv(prompt_len, ps) + boundary if lo.has_full else 0
        win = self._win_span_pages(prompt_len) + boundary if lo.win else 0
        return full + win

    def pages_for_request(self, cache_len_cap: int) -> int:
        """Worst-case pages held at once over a request's whole lifetime."""
        lo = self.layout
        need = cdiv(cache_len_cap, lo.page_size)
        return (need if lo.has_full else 0) + (min(need, lo.pages_win) if lo.win else 0)

    # -- allocation ----------------------------------------------------------

    def fresh_prefill_pages(self, prompt_len: int, shared_len: int = 0) -> int:
        """Fresh pages an admission takes when its first ``shared_len``
        tokens lie in cached pages: a boundary inside a page costs one more,
        the copy-on-write fork of that shared partial page."""
        if shared_len <= 0:
            return self.prefill_pages(prompt_len)
        ps = self.layout.page_size
        return (self.prefill_pages(prompt_len) - cdiv(shared_len, ps)
                + (1 if shared_len % ps else 0))

    def can_admit(self, prompt_len: int, shared_len: int = 0) -> bool:
        return self.fresh_prefill_pages(prompt_len, shared_len) <= len(self._free)

    def add_ref(self, pid: int) -> None:
        """Pin a live page (the prefix index, a shared-prefix admission)."""
        if self._ref[pid] <= 0:
            raise RuntimeError(f"add_ref of free page {pid}")
        self._ref[pid] += 1

    def decref(self, pid: int) -> None:
        """Drop one reference; the page is free at 0."""
        if self._ref[pid] <= 0:
            raise RuntimeError(f"decref of free page {pid}")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)

    def _take(self) -> int:
        pid = self._free.pop()
        self._ref[pid] = 1
        return pid

    def _put(self, key: str, lane: int, pg: int, pid: int) -> None:
        self._pages[key][lane][pg] = pid
        self._pt[key][lane, pg % self.layout.pages_win if key == "win" else pg] = pid
        self._dirty.add(lane)

    def _map(self, key: str, lane: int, pg: int) -> None:
        self._put(key, lane, pg, self._take())

    def _cow_full(self, lane: int, pg: int) -> None:
        """Fork the shared full-table page ``pg`` the lane is about to
        write: a fresh page takes its place and the copy is queued.  The
        source keeps one extra reference until ``apply_pending`` lands the
        copy, so nothing can take and overwrite it first."""
        src = self._pages["full"][lane][pg]
        dst = self._take()
        self._ref[src] += 1  # the pending copy's pin
        self.pending_copies.append((src, dst))
        self.cow_copies += 1
        self._put("full", lane, pg, dst)
        self.decref(src)  # the lane's own claim moves to dst

    def alloc_prefill(self, lane: int, prompt_len: int, shared_full: tuple = (),
                      shared_len: int = 0, defer_win: bool = False) -> bool:
        """Map every page the prompt's cache entries land in (in the window
        table only its live window span) plus the page of the first decode
        write; False (nothing allocated) if the pool is short.  Nothing is
        evicted here: the prefill still writes into the oldest window page,
        so eviction waits for the first ``ensure_steps``.

        ``shared_full`` (from the prefix index) are cached pages mapped at
        full-table pages ``0..``, each gaining a reference, covering
        ``shared_len`` tokens; a boundary inside a page forks that last
        shared page (the lane writes its tail there).  Shared prefixes need
        an append-only table without a window one.  ``defer_win`` (a
        windowed chunked prefill) maps no window pages: each chunk's are
        mapped just before it runs (``ensure_steps``)."""
        if shared_full and (not self.layout.has_full or self.layout.win
                            or shared_len >= prompt_len):
            raise ValueError(f"a shared prefix of {shared_len} tokens needs an append-only "
                             f"pool without a window table and a longer prompt ({prompt_len})")
        if self.fresh_prefill_pages(prompt_len, shared_len) > len(self._free):
            return False
        lo, ps = self.layout, self.layout.page_size
        nxt = prompt_len // ps
        if lo.has_full:
            for pg, pid in enumerate(shared_full):
                self.add_ref(pid)
                self._put("full", lane, pg, pid)
            if shared_full and shared_len % ps:
                self._cow_full(lane, len(shared_full) - 1)
            for pg in list(range(cdiv(prompt_len, ps))) + [nxt]:
                if pg not in self._pages["full"][lane]:
                    self._map("full", lane, pg)
        if lo.win and prompt_len > 0 and not defer_win:
            for pg in range(max(0, prompt_len - lo.win) // ps, (prompt_len - 1) // ps + 1):
                self._map("win", lane, pg)
            if nxt not in self._pages["win"][lane]:
                self._map("win", lane, nxt)
        self._dirty.add(lane)
        return True

    def prompt_pages(self, lane: int, length: int) -> tuple[list[int], Optional[int]]:
        """The full-table pages holding a lane's first ``length`` tokens, for
        the prefix index: ``(whole pages, the partial tail page or None)``,
        the tail holding ``length % page_size`` tokens."""
        ps, pages = self.layout.page_size, self._pages["full"][lane]
        n = length // ps
        return [pages[pg] for pg in range(n)], (pages.get(n) if length % ps else None)

    def ensure_steps(self, lane: int, pos: int, k: int = 1) -> bool:
        """Back the next ``k`` decode writes at ``pos..pos+k-1``; all or
        nothing, False when the pool is short.  First evicts the window
        pages wholly before the oldest position the write at ``pos`` still
        attends to (pages expiring within the dispatch go at the next)."""
        lo, ps = self.layout, self.layout.page_size
        if lo.win:
            self._evict_win(lane, pos)
        k = max(1, min(k, self.max_len - pos))  # writes past max_len freeze
        pages = range(pos // ps, (pos + k - 1) // ps + 1)
        need = [(key, pg) for key, on in (("full", lo.has_full), ("win", bool(lo.win)))
                if on for pg in pages if pg not in self._pages[key][lane]]
        # mapped pages these writes touch that another holder can still
        # read: each forks, for one fresh page
        full = self._pages["full"][lane]
        cow = [pg for pg in pages if pg in full and self._ref[full[pg]] > 1]
        if len(need) + len(cow) > len(self._free):
            return False
        for pg in cow:
            self._cow_full(lane, pg)
        for key, pg in need:
            self._map(key, lane, pg)
        return True

    def _evict_win(self, lane: int, pos: int) -> None:
        lo, ps = self.layout, self.layout.page_size
        start = max(0, pos - lo.win + 1)  # the oldest live position after this write
        pages = self._pages["win"][lane]
        for pg in [pg for pg in pages if (pg + 1) * ps - 1 < start]:
            pid = pages.pop(pg)
            self.decref(pid)
            self.evicted_pages += 1
            if self._pt["win"][lane, pg % lo.pages_win] == pid:
                self._pt["win"][lane, pg % lo.pages_win] = lo.sentinel
            self._dirty.add(lane)

    def rollback(self, lane: int, new_len: int) -> None:
        """Truncate a lane to ``new_len`` committed tokens after a
        speculative round: full-table pages past logical page ``new_len //
        page_size`` (the page of the next write, which stays mapped) are
        dereferenced, not freed, so a shared prefix page or a fork another
        holder still reads stays resident.  A page with a pending copy into
        it is skipped (the engine lands copies before every round, so none
        should be there).  The device half is the round's rewind of
        ``cache["len"]``: K/V past it is dead under the length masks.
        Window tables are left alone (speculation is refused on windowed
        archs)."""
        lo, ps = self.layout, self.layout.page_size
        if not lo.has_full:
            return
        keep = new_len // ps
        pend_dst = {d for _, d in self.pending_copies}
        pages = self._pages["full"][lane]
        for pg in [p for p in pages if p > keep]:
            pid = pages[pg]
            if pid in pend_dst:
                continue
            del pages[pg]
            self.decref(pid)
            if self._pt["full"][lane, pg] == pid:
                self._pt["full"][lane, pg] = lo.sentinel
            self._dirty.add(lane)

    def release(self, lane: int) -> None:
        """Drop the lane's pages in both tables (request finished or
        preempted)."""
        for key, pages in self._pages.items():
            for pid in pages[lane].values():
                self.decref(pid)
            if pages[lane]:
                self._dirty.add(lane)
            pages[lane] = {}
            self._pt[key][lane, :] = self.layout.sentinel

    # -- staged admissions (device-resident refill) --------------------------

    def _stage_exposure(self, prompt_len: int, budget: int, horizon: int) -> int:
        """Positions ``0..e-1`` a staged request's refill may write before
        the host next reconciles: the write horizon, capped by the
        request's own freeze point."""
        cap = min(self.max_len, prompt_len + max(1, budget))
        return min(max(1, horizon), cap)

    def staged_pages(self, prompt_len: int, budget: int, horizon: int) -> int:
        """Fresh pages one staged admission reserves."""
        lo = self.layout
        n = cdiv(self._stage_exposure(prompt_len, budget, horizon), lo.page_size)
        return n * (int(lo.has_full) + int(bool(lo.win)))

    def stage_alloc(self, prompt_len: int, budget: int, horizon: int) -> Optional[dict]:
        """Reserve the pages of a staged request's exposure and build its
        sentinel-padded table rows; None (nothing reserved) when the pool
        is short.  The record is host bookkeeping only: no lane's row or
        device table changes."""
        lo, ps = self.layout, self.layout.page_size
        if self.staged_pages(prompt_len, budget, horizon) > len(self._free):
            return None
        e = self._stage_exposure(prompt_len, budget, horizon)
        rec = {"exposure": e}
        for key, on, width in (("full", lo.has_full, lo.pages_full),
                               ("win", bool(lo.win), lo.pages_win)):
            rec[f"{key}_pages"], rec[f"{key}_row"] = {}, None
            if not on:
                continue
            row = np.full(width, lo.sentinel, np.int32)
            for pg in range(cdiv(e, ps)):
                pid = self._take()
                rec[f"{key}_pages"][pg] = pid
                row[pg % lo.pages_win if key == "win" else pg] = pid
            rec[f"{key}_row"] = row
        return rec

    def release_staged(self, rec: dict) -> None:
        """Return an unconsumed stage's pages (its request goes back to the
        queue)."""
        for key in ("full", "win"):
            for pid in rec[f"{key}_pages"].values():
                self.decref(pid)

    def adopt_staged(self, lane: int, rec: dict) -> None:
        """Install a consumed stage as ``lane``'s mappings (the host's replay
        of a refill inside the loop).  The device rows already hold these
        ids; the lane is marked dirty, so the next sync rewrites the same
        values."""
        if any(self._pages[key][lane] for key in self._pages):
            raise RuntimeError(f"adopt_staged into occupied lane {lane}")
        for key in ("full", "win"):
            self._pages[key][lane] = dict(rec[f"{key}_pages"])
            if rec[f"{key}_row"] is not None:
                self._pt[key][lane, :] = rec[f"{key}_row"]
        self._dirty.add(lane)

    # -- copy-on-write -------------------------------------------------------

    def apply_pending(self) -> dict:
        """Copy the queued forks' rows ``src -> dst`` in place in every page
        pool of the pool's cache (``models.model.copy_pages``): each K/V or
        latent leaf and each ``*_scale`` plane, every layer, pairs chained
        through a ``dst`` that is a later ``src`` one by one, in order.  The
        tensors keep their addresses (a captured decode loop holds them).
        The sources then drop their pin.  Returns the cache."""
        if not self.pending_copies:
            return self.cache
        if self.layout.shards > 1:
            raise NotImplementedError("copy-on-write over a pages-sharded pool is not ported "
                                      "yet (the rest of tensor parallelism, ROADMAP.md)")
        pairs, self.pending_copies = self.pending_copies, []
        srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
        batches = [([s], [d]) for s, d in pairs] if set(srcs) & set(dsts) else [(srcs, dsts)]
        dev = self.cache["len"].device
        for s, d in batches:
            copy_pages(self.cfg, self.cache, self.layout, torch.tensor(s, device=dev),
                       torch.tensor(d, device=dev))
        for s in srcs:
            self.decref(s)
        return self.cache

    # -- device view ---------------------------------------------------------

    def device_tables(self) -> dict:
        """The page tables on the device, synced incrementally: the first
        call uploads the whole tables, later calls copy only dirty rows."""
        dev_tables = self.cache["tables"]
        if not self._synced:
            for key, dev_pt in dev_tables.items():
                dev_pt.copy_(torch.from_numpy(self._pt[key]))
            self._synced = True
            self.table_full_uploads += 1
            self.table_syncs += 1
        elif self._dirty:
            rows = sorted(self._dirty)
            for key, dev_pt in dev_tables.items():
                dev_pt[torch.tensor(rows, device=dev_pt.device)] = (
                    torch.from_numpy(self._pt[key][rows]).to(dev_pt.device))
            self.table_row_syncs += len(rows)
            self.table_syncs += 1
        self._dirty.clear()
        return dev_tables
