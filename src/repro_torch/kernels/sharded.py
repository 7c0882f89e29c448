"""Per-shard kernel wrappers of tensor-parallel serving (counterpart of
``repro/kernels/sharded.py``).

The reference runs its kernels per shard under ``shard_map`` and combines
the partial results with ``pmax``/``psum`` over the ``model`` mesh axis.
Here each shard is a ``torch.distributed`` rank (``launch.mesh``) and the
combines are collectives over the mesh's model-axis group:

- :func:`paged_attn_sharded`: the KV pool's *pages* axis is split over the
  ranks (``PagedLayout.shards``), page tables, queries and lengths are
  replicated.  Each rank rewrites the table to its own page range
  (:func:`shard_local_tables`: foreign pages and the global sentinel
  become the local sentinel), runs the stats form of ``paged_attn`` (K3)
  over its slice, and :func:`combine_stats` renormalizes the flash
  triples: one ``all_reduce(MAX)`` of the maxima and one ``all_reduce(SUM)``
  of the rescaled accumulators and denominators together, in f32; the
  result is cast to the query type only after the divide.
- :func:`nm_spmm_sharded`: a compressed leaf whose group (reduction) axis
  is split (``CompressedTensor.rshards``; whole N:M groups per rank, since
  placement needs ``K % (m · ranks) == 0``) multiplies the rank's K-slice
  of the replicated activation (or, with ``local``, an activation that is
  already that slice: the rank's own heads) by its group rows with
  ``nm_spmm`` (K1), then the partial outputs sum in f32 and are cast back.
  :func:`nm_spmm_batched_sharded` is the same route of the batched K1
  (K1b) for reduction-sharded MoE expert stacks: each expert's K-slice of
  the replicated ``(E, C, K)`` buffer, one launch, one sum.
- :func:`all_gather` completes output-sharded matmuls and the
  vocab-sharded unembedding; :func:`embed_sharded` looks tokens up in a
  vocab-sharded table (rows of other ranks' tokens are zero) and sums.
- :func:`gather_data` joins the data rows' lanes over the mesh's data
  group (a decode dispatch's token block, a prefill batch's first tokens),
  so every rank's host scheduler absorbs the same tokens.

Windowed (modular) tables are safe to remap: which logical page a slot
holds depends only on the slot and the lane's length, never on the
physical id it stores.

Sums carry f32 (bf16 widened exactly, and narrowed back exactly after a
sum with zeros) and gathers the tensor's own type, so every rank sees the
same bits; the
count of collectives issued is kept in :data:`collectives` and the host
seconds spent inside them in :data:`collective_s` (a collective on card
tensors first waits for the device work it depends on, so this is an
upper bound of the communication).  The engine
makes its mesh the active one (:func:`mesh_context`) around prefill and
decode; a sharded leaf used with no active mesh raises.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.nm_spmm import nm_spmm, nm_spmm_batched
from repro_torch.kernels.paged_attn import Stats, paged_attn

collectives = 0  # collectives issued since the last reset_collectives()
collective_s = 0.0  # host seconds inside them
_ACTIVE: list = []


def reset_collectives() -> None:
    global collectives, collective_s
    collectives, collective_s = 0, 0.0


def _issue(call, *args, **kw) -> None:
    global collectives, collective_s
    t0 = time.perf_counter()
    call(*args, **kw)
    collective_s += time.perf_counter() - t0
    collectives += 1


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the one sharded leaves and pools combine over."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    if not _ACTIVE or _ACTIVE[-1] is None:
        raise RuntimeError("a sharded leaf or pool was used outside mesh_context()")
    return _ACTIVE[-1]


def split_mesh():
    """The active mesh if its model axis has more than one rank, else None."""
    mesh = _ACTIVE[-1] if _ACTIVE else None
    return mesh if mesh is not None and mesh.model > 1 else None


def own_range(n: int, mesh=None) -> tuple[int, int]:
    """This rank's ``[lo, hi)`` of ``n`` items split evenly, in order, over
    the model axis (``n`` must divide)."""
    mesh = mesh or active_mesh()
    if n % mesh.model:
        raise ValueError(f"{n} items do not split over {mesh.model} ranks")
    per = n // mesh.model
    return mesh.model_index * per, (mesh.model_index + 1) * per


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous f32 copy that a collective may overwrite."""
    return x.to(torch.float32, copy=True).contiguous()


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM, mesh=None) -> torch.Tensor:
    """``x`` reduced over the model axis, in f32."""
    mesh = mesh or active_mesh()
    y = _wire(x)
    _issue(dist.all_reduce, y, op=op, group=mesh.group)
    return y


def all_gather(x: torch.Tensor, dim: int = -1, mesh=None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in model-axis order, in
    ``x``'s type, which is also the wire's: a gather moves bits and sums
    nothing (a bf16 activation in f32 doubled the bytes of the largest
    collectives, RecurrentGemma's prefill gathers)."""
    mesh = mesh or active_mesh()
    return _gather(x, dim, mesh.group, mesh.model)


def gather_data(x: torch.Tensor, dim: int = -1, mesh=None) -> torch.Tensor:
    """The data rows' ``x`` concatenated along ``dim`` in data-axis order
    (their lanes in global order), in ``x``'s type."""
    mesh = mesh or active_mesh()
    return _gather(x, dim, mesh.data_group, mesh.data)


def _gather(x: torch.Tensor, dim: int, group, ranks: int) -> torch.Tensor:
    y = x.contiguous()
    parts = [torch.empty_like(y) for _ in range(ranks)]
    _issue(dist.all_gather, parts, y, group=group)
    return torch.cat(parts, dim)


def shard_local_tables(tables: torch.Tensor, shard: int,
                       pages_per_shard: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A replicated table of global page ids (sentinel = the global pool
    size) as shard ``shard`` sees it: ``(local_tables, resident)``.  Pages
    in ``[shard·per, (shard+1)·per)`` become ``phys - shard·per``; every
    other entry, the global sentinel included, becomes the local sentinel
    ``per``.  A lane with no resident page gets an all-sentinel row, on
    which K3 returns the dead-lane triple."""
    local = tables - shard * pages_per_shard
    resident = (local >= 0) & (local < pages_per_shard)
    return torch.where(resident, local, pages_per_shard).to(tables.dtype), resident


def _merge(acc, m, l, m_g, total):
    """The rescaled sums ``(acc, l)`` of the flash combine at max ``m_g``."""
    corr = torch.exp(m - m_g)
    both = total(torch.cat([acc * corr[..., None], (l * corr)[..., None]], -1))
    return both[..., :-1], both[..., -1]


def _normalize(acc, l):
    return acc / l.clamp_min(1e-30)[..., None]


def combine_stats(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                  mesh=None) -> torch.Tensor:
    """The flash combine over the model axis: the global max, each shard's
    ``l`` and ``acc`` rescaled by ``exp(m - m_g)`` and summed, then one
    divide; f32 out.  Dead shards (``m = -1e30, l = 0``) add exact zeros; a
    lane dead on every shard keeps ``l = 0`` and gives zeros through the
    clamp, as the single-shard kernel does."""
    mesh = mesh or active_mesh()
    m_g = all_reduce(m, dist.ReduceOp.MAX, mesh)
    return _normalize(*_merge(acc.float(), m.float(), l.float(), m_g,
                              lambda x: all_reduce(x, dist.ReduceOp.SUM, mesh)))


def merge_stats_local(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> Stats:
    """The merged f32 triple ``(acc, m, l)`` of a stacked shard axis 0 of
    one process's tensors, before the divide: what the window kernel's
    combine flushes in the stats form."""
    acc, m, l = acc.float(), m.float(), l.float()
    m_g = m.amax(0)
    acc, l = _merge(acc, m, l, m_g, lambda x: x.sum(0))
    return acc, m_g, l


def combine_stats_local(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """:func:`combine_stats` over a stacked shard axis 0 of one process's
    tensors (the one-card split check)."""
    acc, _, l = merge_stats_local(acc, m, l)
    return _normalize(acc, l)


def paged_attn_sharded(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: Optional[torch.Tensor],
    tables: torch.Tensor, lengths: torch.Tensor, *, scale: float, mesh=None, **kw,
) -> torch.Tensor:
    """Paged decode attention over this rank's slice ``(P/S, ps, ...)`` of a
    pages-sharded pool (int8 scale planes sliced with it): the table
    remapped to the slice, K3, the combine; ``q.dtype`` out.  ``kw`` are
    ``paged_attn``'s options (window, MLA, scale planes)."""
    mesh = mesh or active_mesh()
    per = k_pages.shape[0]
    local, _ = shard_local_tables(tables, mesh.model_index, per)
    acc, m, l = paged_attn(q, k_pages, v_pages, local.contiguous(), lengths, scale=scale,
                           emit_stats=True, **kw)
    return combine_stats(acc, m, l, mesh).to(q.dtype)


def _k_slice(x: torch.Tensor, values: torch.Tensor, n: int, m: int, local: bool,
             mesh) -> torch.Tensor:
    """The rank's K-slice of ``x`` (its last axis) for group rows
    ``values`` (``(..., K/S·n/m, O)``): ``x`` itself where ``local``."""
    kl = values.shape[-2] * m // n
    k = x.shape[-1] if not local else x.shape[-1] * mesh.model
    if k != kl * mesh.model or k % (m * mesh.model):
        raise ValueError(f"K={k} does not split into whole {m}-groups of {kl} a rank over "
                         f"{mesh.model} shards")
    if local:
        return x.contiguous()
    return x[..., mesh.model_index * kl:(mesh.model_index + 1) * kl].contiguous()


def nm_spmm_sharded(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor, n: int,
                    m: int, o_true: Optional[int] = None, mesh=None,
                    local: bool = False) -> torch.Tensor:
    """``x @ W`` for this rank's group rows ``values``/``indices`` of a
    reduction-sharded ``W``: x ``(B, K)`` replicated (or, ``local``, ``(B,
    K/S)``: the rank's slice already); K1 on the rank's K-slice, the
    partial outputs summed in f32, cast to ``x.dtype``."""
    mesh = mesh or active_mesh()
    part = nm_spmm(_k_slice(x, values, n, m, local, mesh), values, indices, n, m, o_true)
    return all_reduce(part, dist.ReduceOp.SUM, mesh).to(x.dtype)


def nm_spmm_batched_sharded(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                            n: int, m: int, o_true: Optional[int] = None,
                            mesh=None) -> torch.Tensor:
    """``x[e] @ W[e]`` for this rank's group rows ``(E, K/S·n/m, O)`` of a
    reduction-sharded expert stack: x ``(E, C, K)`` replicated; K1b on every
    expert's K-slice in one launch, the partial outputs summed in f32, cast
    to ``x.dtype``."""
    mesh = mesh or active_mesh()
    part = nm_spmm_batched(_k_slice(x, values, n, m, False, mesh), values, indices, n, m,
                           o_true)
    return all_reduce(part, dist.ReduceOp.SUM, mesh).to(x.dtype)


def embed_sharded(tok: torch.Tensor, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """Rows of a vocab-sharded table ``tok`` (this rank's ``V/S`` rows) for
    replicated ``tokens``: a masked local lookup, then a sum over ranks."""
    mesh = mesh or active_mesh()
    rows = tok.shape[0]
    local = tokens.long() - mesh.model_index * rows
    own = (local >= 0) & (local < rows)
    x = torch.where(own[..., None], tok[local.clamp(0, rows - 1)], 0)
    return all_reduce(x, dist.ReduceOp.SUM, mesh).to(tok.dtype)
