"""Host-side paged KV pool (counterpart of ``repro/serving/kv_pool.py``).

``PagedKVPool`` owns the device cache (one ``(..., P + 1, ps, ...)`` pool per
cache leaf of each attention or MLA layer stack, see
``models.cache.PagedLayout``; every layer reads the same page tables), the
free-page list with per-page refcounts, and the per-lane append-only page
tables.  The
tables are mirrored host-side in numpy and synced to the device
incrementally: mutations mark their lane dirty, and ``device_tables``
copies only dirty rows into the resident device table.

The engine asks ``can_admit``/``alloc_prefill`` at admission,
``ensure_steps(lane, pos, k)`` before every decode dispatch (reserving all K
writes, so a dispatch never runs out of pages midway) and ``release`` on
finish or preemption.  The device table is updated in place, so unlike the
reference there is no donated buffer to re-adopt.  Copy-on-write, prefix
sharing, staged refills, rollback and window tables are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.cache import PagedLayout, cdiv, paged_layout_for
from repro_torch.models.model import init_cache


class PagedKVPool:
    def __init__(self, cfg, *, max_batch: int, max_len: int, num_pages: int,
                 page_size: int = 16, device="cuda"):
        self.layout: PagedLayout = paged_layout_for(
            cfg, max_len, page_size=page_size, num_pages=num_pages)
        self.max_batch = max_batch
        self.max_len = max_len
        self.cache = init_cache(cfg, max_batch, max_len, layout=self.layout, device=device)
        self._pt = np.full((max_batch, self.layout.pages_full), self.layout.sentinel,
                           np.int32)
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._ref = np.zeros(num_pages, np.int32)  # 0 = free, 1 = owned by a lane
        self._pages: list[dict[int, int]] = [dict() for _ in range(max_batch)]
        self._dirty: set[int] = set(range(max_batch))
        self._synced = False
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

    def lane_pages(self, lane: int) -> dict[int, int]:
        """Logical page number -> page id of one lane (a copy)."""
        return dict(self._pages[lane])

    def prefill_pages(self, prompt_len: int) -> int:
        """Pages a prompt needs through its first decode write at position
        ``prompt_len`` (reserved up front, so a freshly prefilled lane is
        never preempted by its first ``ensure_steps``)."""
        ps = self.layout.page_size
        return cdiv(prompt_len, ps) + (1 if prompt_len % ps == 0 else 0)

    def pages_for_request(self, cache_len_cap: int) -> int:
        """Worst-case pages over a request's whole lifetime."""
        return cdiv(cache_len_cap, self.layout.page_size)

    # -- allocation ----------------------------------------------------------

    def can_admit(self, prompt_len: int) -> bool:
        return self.prefill_pages(prompt_len) <= len(self._free)

    def _take(self) -> int:
        pid = self._free.pop()
        self._ref[pid] = 1
        return pid

    def _decref(self, pid: int) -> None:
        if self._ref[pid] <= 0:
            raise RuntimeError(f"decref of free page {pid}")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)

    def _map(self, lane: int, pg: int) -> None:
        pid = self._take()
        self._pages[lane][pg] = pid
        self._pt[lane, pg] = pid
        self._dirty.add(lane)

    def alloc_prefill(self, lane: int, prompt_len: int) -> bool:
        """Map every page the prompt lands in plus the page of the first
        decode write; False (nothing allocated) if the pool is short."""
        if not self.can_admit(prompt_len):
            return False
        ps = self.layout.page_size
        for pg in range(cdiv(prompt_len, ps)):
            self._map(lane, pg)
        if prompt_len // ps not in self._pages[lane]:
            self._map(lane, prompt_len // ps)
        return True

    def ensure_steps(self, lane: int, pos: int, k: int = 1) -> bool:
        """Back the next ``k`` decode writes at ``pos..pos+k-1``; all or
        nothing, False when the pool is short."""
        ps = self.layout.page_size
        k = max(1, min(k, self.max_len - pos))  # writes past max_len freeze
        need = [pg for pg in range(pos // ps, (pos + k - 1) // ps + 1)
                if pg not in self._pages[lane]]
        if len(need) > len(self._free):
            return False
        for pg in need:
            self._map(lane, pg)
        return True

    def release(self, lane: int) -> None:
        """Drop the lane's pages (request finished or preempted)."""
        for pid in self._pages[lane].values():
            self._decref(pid)
        if self._pages[lane]:
            self._dirty.add(lane)
        self._pages[lane] = {}
        self._pt[lane, :] = self.layout.sentinel

    # -- device view ---------------------------------------------------------

    def device_tables(self) -> dict:
        """The page tables on the device, synced incrementally: the first
        call uploads the whole table, later calls copy only dirty rows."""
        dev_pt = self.cache["tables"]["full"]
        if not self._synced:
            dev_pt.copy_(torch.from_numpy(self._pt))
            self._synced = True
            self.table_full_uploads += 1
            self.table_syncs += 1
        elif self._dirty:
            rows = sorted(self._dirty)
            dev_pt[torch.tensor(rows, device=dev_pt.device)] = (
                torch.from_numpy(self._pt[rows]).to(dev_pt.device))
            self.table_row_syncs += len(rows)
            self.table_syncs += 1
        self._dirty.clear()
        return self.cache["tables"]
