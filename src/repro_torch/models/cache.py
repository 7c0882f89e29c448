"""KV-cache layouts (counterpart of ``repro/models/cache.py``).

- :class:`SlabLayout`: a contiguous ``(L, B, max_len, Hkv, D)`` slab.
- :class:`PagedLayout`: a ``(L, P + 1, ps, Hkv, D)`` pool behind per-lane
  page tables ``(B, ceil(max_len / ps))`` int32, append-only (slot ``p``
  holds positions ``[p·ps, (p+1)·ps)``); unmapped slots hold the sentinel
  ``P``.

The JAX package leans on out-of-range scatters being dropped: writes of idle
lanes, pad rows and frozen lanes aim at the sentinel page ``P`` and vanish.
PyTorch raises on such an index, so the paged pool carries one extra page at
index ``P`` that absorbs those writes; it is never read (the kernel and the
plain attention see only pages ``[0, P)``).  Slab writes past the slab's end
are masked per lane instead.

Writes update the cache tensors in place.  Sliding-window (modular) tables
and int8 pages are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class SlabLayout:
    """Contiguous ``(B, max_len, ...)`` per-lane cache."""

    max_len: int
    kind = "slab"

    def attn_alloc(self, n_layers: int, batch: int, n_kv: int, hd: int, dtype,
                   device) -> dict:
        shp = (n_layers, batch, self.max_len, n_kv, hd)
        return {"k": torch.zeros(shp, dtype=dtype, device=device),
                "v": torch.zeros(shp, dtype=dtype, device=device)}

    def tables(self, batch: int, device):
        return None

    def attn_write(self, c: dict, k_new, v_new, pos, tables) -> None:
        """Write one token per lane at ``pos`` into one layer's ``c``
        (``(B, S, ...)``); lanes at ``pos >= S`` (frozen at capacity) keep
        their contents, as the reference's dropped scatter does."""
        s = c["k"].shape[1]
        bidx = torch.arange(pos.shape[0], device=pos.device)
        ok = (pos < s)[:, None, None]
        slot = pos.clamp(max=s - 1)
        for name, x in (("k", k_new), ("v", v_new)):
            old = c[name][bidx, slot]
            c[name][bidx, slot] = torch.where(ok, x.to(old.dtype), old)

    def attn_write_rows(self, c: dict, k_rows, v_rows, lanes, lens, tables) -> None:
        """Write prefilled rows ``(L, N, Lp, ...)`` into lanes ``lanes``
        (distinct, all real) of the stacked cache.  Positions ``>= lens``
        get the prompt's pad entries: dead under the length mask, and
        overwritten by later decode writes."""
        lp = k_rows.shape[2]
        c["k"][:, lanes, :lp] = k_rows.to(c["k"].dtype)
        c["v"][:, lanes, :lp] = v_rows.to(c["v"].dtype)


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Block-granular pool behind append-only page tables."""

    page_size: int
    num_pages: int
    max_len: int
    kind = "paged"

    @property
    def pages_full(self) -> int:
        return cdiv(self.max_len, self.page_size)

    @property
    def sentinel(self) -> int:
        return self.num_pages

    def attn_alloc(self, n_layers: int, batch: int, n_kv: int, hd: int, dtype,
                   device) -> dict:
        shp = (n_layers, self.num_pages + 1, self.page_size, n_kv, hd)  # +1: sink page
        return {"k": torch.zeros(shp, dtype=dtype, device=device),
                "v": torch.zeros(shp, dtype=dtype, device=device)}

    def tables(self, batch: int, device) -> dict:
        return {"full": torch.full((batch, self.pages_full), self.sentinel,
                                   dtype=torch.int32, device=device)}

    def pool_view(self, pages: torch.Tensor) -> torch.Tensor:
        """The ``(P, ps, ...)`` pages attention reads (the sink page cut)."""
        return pages[: self.num_pages]

    def _scatter(self, c: dict, entries: dict, widx: torch.Tensor) -> None:
        for name, x in entries.items():
            pool = c[name]
            flat = pool.view(pool.shape[:-4] + (-1,) + pool.shape[-2:])
            flat[..., widx, :, :] = x.to(pool.dtype)

    def attn_write(self, c: dict, k_new, v_new, pos, tables) -> None:
        """Scatter one token per lane into its page of one layer's pool
        ``(P + 1, ps, ...)``; unmapped slots and positions past the table
        land on the sink page."""
        pt = tables["full"]
        page = pos.long() // self.page_size
        phys = pt.gather(1, page.clamp(max=pt.shape[1] - 1)[:, None])[:, 0]
        phys = torch.where(page < pt.shape[1], phys, self.sentinel)
        widx = phys.long() * self.page_size + pos.long() % self.page_size
        self._scatter(c, {"k": k_new, "v": v_new}, widx)

    def attn_write_rows(self, c: dict, k_rows, v_rows, lanes, lens, tables) -> None:
        """Scatter prefilled rows ``(L, N, Lp, ...)`` of lanes ``lanes``
        into the stacked pool; positions ``>= lens`` go to the sink page."""
        ps = self.page_size
        n, lp = k_rows.shape[1:3]
        a = torch.arange(lp, device=lens.device)[None, :]
        phys = tables["full"][lanes.long()][:, : cdiv(lp, ps)]
        phys = phys.repeat_interleave(ps, dim=1)[:, :lp].long()  # (N, Lp)
        widx = torch.where(a < lens[:, None], phys * ps + a % ps,
                           self.sentinel * ps).reshape(-1)
        self._scatter(c, {"k": k_rows.reshape((k_rows.shape[0], n * lp) + k_rows.shape[3:]),
                          "v": v_rows.reshape((v_rows.shape[0], n * lp) + v_rows.shape[3:])},
                      widx)


def paged_layout_for(cfg, max_len: int, *, page_size: int, num_pages: int) -> PagedLayout:
    if cfg.local_window is not None:
        raise NotImplementedError(
            "sliding-window (modular) page tables are not ported yet; see ROADMAP.md"
        )
    return PagedLayout(page_size=page_size, num_pages=num_pages, max_len=max_len)
