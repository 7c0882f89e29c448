"""KV-cache layouts (counterpart of ``repro/models/cache.py``).

- :class:`SlabLayout`: a contiguous ``(..., B, max_len, ...)`` slab.
- :class:`PagedLayout`: a ``(..., P + 1, ps, ...)`` pool behind per-lane
  page tables ``(B, ceil(max_len / ps))`` int32, append-only (slot ``p``
  holds positions ``[p·ps, (p+1)·ps)``); unmapped slots hold the sentinel
  ``P``.

A layer's cache entry is a dict of leaves, each with its own per-token
shape: ``{"k", "v"}`` of ``(Hkv, D)`` for attention, ``{"ckv", "krope"}`` of
``(kv_lora,)`` / ``(rope_dim,)`` for MLA's latents.  Leading axes stack
layers (``(L, ...)`` under ``body``; none for a ``head_*`` layer).  The
layouts treat every leaf alike: ``alloc`` is the reference's
``attn_alloc``/``mla_alloc``, ``write`` (one token per lane into one
layer's entry) its ``attn_write``/``mla_write``, ``write_rows`` (prefilled
rows into a stacked entry) its ``attn_write_rows``/``mla_write_rows``.
MLA's expanded decode runs on the slab only and reads the slab itself; on
the pool MLA decodes through the kernel.

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

    max_len: int = 0  # only needed for allocation
    kind = "slab"

    def alloc(self, lead: tuple, batch: int, entries: dict, dtype, device) -> dict:
        """Zeroed ``lead + (B, max_len) + shape`` leaves, one per
        ``entries`` name -> per-token shape."""
        return {name: torch.zeros(lead + (batch, self.max_len) + shp, dtype=dtype,
                                  device=device) for name, shp in entries.items()}

    def tables(self, batch: int, device):
        return None

    def write(self, c: dict, entries: dict, pos, tables) -> None:
        """Write one token per lane at ``pos`` into one layer's ``c``
        (leaves ``(B, S, ...)``); lanes at ``pos >= S`` (frozen at capacity)
        keep their contents, as the reference's dropped scatter does."""
        bidx = torch.arange(pos.shape[0], device=pos.device)
        for name, x in entries.items():
            s = c[name].shape[1]
            slot = pos.clamp(max=s - 1)
            old = c[name][bidx, slot]
            ok = (pos < s).reshape((-1,) + (1,) * (old.dim() - 1))
            c[name][bidx, slot] = torch.where(ok, x.to(old.dtype), old)

    def write_rows(self, c: dict, rows: dict, lanes, lens, tables) -> None:
        """Write prefilled rows ``(L, N, Lp, ...)`` into lanes ``lanes``
        (distinct, all real) of the stacked cache.  Positions ``>= lens``
        get the prompt's pad entries: dead under the length mask, and
        overwritten by later decode writes."""
        for name, x in rows.items():
            c[name][:, lanes, : x.shape[2]] = x.to(c[name].dtype)


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

    def alloc(self, lead: tuple, batch: int, entries: dict, dtype, device) -> dict:
        """Zeroed ``lead + (P + 1, ps) + shape`` pools (the last page is the
        sink), one per ``entries`` name -> per-token shape."""
        pool = (self.num_pages + 1, self.page_size)
        return {name: torch.zeros(lead + pool + shp, dtype=dtype, device=device)
                for name, shp in entries.items()}

    def tables(self, batch: int, device) -> dict:
        return {"full": torch.full((batch, self.pages_full), self.sentinel,
                                   dtype=torch.int32, device=device)}

    def pool_view(self, pages: torch.Tensor) -> torch.Tensor:
        """The ``(P, ps, ...)`` pages attention reads (the sink page cut)."""
        return pages[: self.num_pages]

    @staticmethod
    def _scatter(c: dict, entries: dict, widx: torch.Tensor, lead: int) -> None:
        """Store ``entries`` (``lead`` layer axes, then one token per
        ``widx``) at the pool's flat ``(page, slot)`` indices ``widx``."""
        for name, x in entries.items():
            pool = c[name]
            flat = pool.view(pool.shape[:lead] + (-1,) + pool.shape[lead + 2:])
            flat[(slice(None),) * lead + (widx,)] = x.to(flat.dtype)

    def write(self, c: dict, entries: dict, pos, tables) -> None:
        """Scatter one token per lane into its page of one layer's pool
        ``(P + 1, ps, ...)``; unmapped slots and positions past the table
        land on the sink page."""
        pt = tables["full"]
        page = pos.long() // self.page_size
        phys = pt.gather(1, page.clamp(max=pt.shape[1] - 1)[:, None])[:, 0]
        phys = torch.where(page < pt.shape[1], phys, self.sentinel)
        widx = phys.long() * self.page_size + pos.long() % self.page_size
        self._scatter(c, entries, widx, 0)

    def write_rows(self, c: dict, rows: dict, lanes, lens, tables) -> None:
        """Scatter prefilled rows ``(L, N, Lp, ...)`` of lanes ``lanes``
        into the stacked pool; positions ``>= lens`` go to the sink page."""
        ps = self.page_size
        n, lp = next(iter(rows.values())).shape[1:3]
        a = torch.arange(lp, device=lens.device)[None, :]
        phys = tables["full"][lanes.long()][:, : cdiv(lp, ps)]
        phys = phys.repeat_interleave(ps, dim=1)[:, :lp].long()  # (N, Lp)
        widx = torch.where(a < lens[:, None], phys * ps + a % ps,
                           self.sentinel * ps).reshape(-1)
        self._scatter(c, {name: x.flatten(1, 2) for name, x in rows.items()}, widx, 1)


def paged_layout_for(cfg, max_len: int, *, page_size: int, num_pages: int) -> PagedLayout:
    if cfg.local_window is not None:
        raise NotImplementedError(
            "sliding-window (modular) page tables are not ported yet; see ROADMAP.md"
        )
    return PagedLayout(page_size=page_size, num_pages=num_pages, max_len=max_len)
