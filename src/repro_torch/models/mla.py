"""Multi-head Latent Attention, DeepSeek-V2 (counterpart of ``repro/models/mla.py``).

MLA compresses K/V into a shared latent ``c_kv`` (``kv_lora`` wide) plus one
small RoPE key shared by the heads; per-head K(nope)/V are up-projected from
the latent by ``w_ukv``.  Decode caches only ``(c_kv, k_rope)``.

Decode takes one of two routes, by layout:

- **Slab** (one rank): the reference route (``mla.py:239-255``): write the
  new latent, expand the whole latent view to per-head K/V with
  ``w_ukv`` and attend.
- **Paged**: the absorbed latent route (``mla.py:202-237``) always.  With
  ``W_uk`` folded into the query and ``W_uv`` into the output
  (``q·(c W_uk) = (q W_ukᵀ)·c``, ``Σ p·(c W_uv) = (Σ p·c) W_uv``), attention
  runs in latent space through the page table: K2m (``kernels.paged_attn``
  with ``q2``/``k2_pages``/``v_is_k``) on the card, its plain version on
  the CPU.  As in the reference the latent queries, the RoPE queries and the
  kernel's output stay f32 over pages of the cache's type (int8 pages with
  their ``ckv_scale``/``krope_scale`` planes: K2q), and a compressed
  ``w_ukv`` is decompressed in the step (:func:`_absorbed_ukv`).

Chunked prefill (:func:`mla_chunk`) takes the expanded route on both
layouts, as the reference does: each chunk's latents written, the lane's
whole latent view expanded by ``w_ukv`` through K1 and attended.

Over a model axis (``w_ukv`` and ``w_q`` head-sharded, ``w_dkv`` and
``w_o`` reduction-sharded, as the reference places them), decode takes
the absorbed route on both layouts.  A rank holds ``W_uk``/``W_uv`` of its
``H/S`` heads only: it computes those heads' latent queries and gathers
them (``(B, H, kv_lora)`` f32, one collective), instead of gathering the
weight (``kv_lora × H·(nd + vd)`` a layer and step).  It then attends
every head over the latent rows it holds: its page range through K3's
MLA form (``kernels.sharded.paged_attn_sharded``, ``paged_attn_mla_stats``
or its int8 form), or its rows of the split slab through
``layers.decode_attention_stats`` (plain, as the slab's attention is),
and the ranks' flash triples are combined (``sharded.combine_stats``).
After the combine it applies its heads' ``W_uv`` and hands its heads'
outputs to the reduction-sharded ``w_o``, whose slice they are
(``layers.matmul_own``).  So a layer's step runs 6 collectives on either
layout: ``w_q``'s gather, ``w_dkv``'s sum, the latent queries' gather,
the combine's max and sum, ``w_o``'s sum; none of them grows with the
context.  A slab whose rows the ranks do not divide is whole on every
rank (``SlabLayout.split``) and keeps the reference's expanded route.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.kernels import sharded
from repro_torch.kernels.paged_attn import paged_attn
from repro_torch.models import layers as L
from repro_torch.sparse_infer.compress import CompressedTensor


def _project_qkv(x, p, n_heads: int, cfg: MLAConfig):
    b, s, _ = x.shape
    q = L.matmul(x, p["w_q"]).reshape(b, s, n_heads, cfg.nope_head_dim + cfg.rope_head_dim)
    dkv = L.matmul(x, p["w_dkv"])  # (B, S, kv_lora + rd)
    return q, dkv[..., : cfg.kv_lora], dkv[..., cfg.kv_lora:]


def _absorbed_ukv(p, n_heads: int, cfg: MLAConfig):
    """``(W_uk, W_uv)`` as ``(kv_lora, H, nd)`` / ``(kv_lora, H, vd)``, ``H``
    the heads this rank holds (``n_heads`` / ``oshards`` of a head-sharded
    ``w_ukv``); a compressed ``w_ukv`` is decompressed here, in the step."""
    w = p["w_ukv"]
    wd = w.dense() if isinstance(w, CompressedTensor) else w
    nd = cfg.nope_head_dim
    wd = wd.reshape(cfg.kv_lora, -1, nd + cfg.v_head_dim)
    return wd[..., :nd], wd[..., nd:]


def _qkv_rope(x, p, n_heads: int, cfg: MLAConfig, positions, theta: float):
    """Projections with RoPE applied: ``(q_nope, q_rope, c_kv, k_rope)``,
    ``k_rope`` as ``(B, S, rd)``."""
    nd = cfg.nope_head_dim
    q, c_kv, k_rope = _project_qkv(x, p, n_heads, cfg)
    q_rope = L.apply_rope(q[..., nd:], positions, theta)
    k_rope = L.apply_rope(k_rope[:, :, None, :], positions, theta)[:, :, 0, :]
    return q[..., :nd], q_rope, c_kv, k_rope


def _expanded_attention(q_nope, q_rope, ckv, krope, p, n_heads: int, cfg: MLAConfig):
    """Per-head K/V expanded from the latent view: ``(qf, kf, v padded to
    nd + rd)`` for one attention over both score streams."""
    b, s = ckv.shape[:2]
    nd, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    ukv = L.matmul(ckv, p["w_ukv"]).reshape(b, s, n_heads, nd + vd)
    kf = torch.cat([ukv[..., :nd], krope[:, :, None, :].expand(b, s, n_heads, rd)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    v = torch.nn.functional.pad(ukv[..., nd:], (0, nd + rd - vd))
    return qf, kf, v


def mla_attention(x, p, n_heads: int, cfg: MLAConfig, positions,
                  rope_theta: float = 10000.0, chunk: int = 512):
    """Full-sequence MLA (prefill): ``(out (B, S, d), (c_kv, k_rope))``."""
    b, s, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _qkv_rope(x, p, n_heads, cfg, positions, rope_theta)
    qf, kf, v = _expanded_attention(q_nope, q_rope, c_kv, k_rope, p, n_heads, cfg)
    out = L.chunked_attention(qf, kf, v, chunk=chunk)[..., : cfg.v_head_dim]
    return L.matmul(out.reshape(b, s, n_heads * cfg.v_head_dim), p["w_o"]), (c_kv, k_rope)


def mla_chunk(x, p, n_heads: int, cfg: MLAConfig, cache: dict, lanes, starts, lengths,
              rope_theta: float = 10000.0, layout=None, tables=None, chunk: int = 512):
    """One batched chunked-prefill step of one layer (the reference's
    ``mla_chunk``): row ``r`` of x ``(R, C, d)`` writes its latents at
    positions ``starts[r] + i`` (``i < lengths[r]``) of lane ``lanes[r]``
    in place, then its queries attend over that lane's whole latent view,
    expanded to per-head K/V by ``w_ukv`` (K1 over ``R × S`` rows).  Pad
    rows and entries give garbage the caller discards."""
    b, csz, _ = x.shape
    positions = starts.long()[:, None] + torch.arange(csz, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _qkv_rope(x, p, n_heads, cfg, positions, rope_theta)
    layout.write_chunk(cache, {"ckv": c_kv, "krope": k_rope}, lanes, starts, lengths, tables)
    view = layout.chunk_view(cache, lanes, tables)  # an int8 pool's dequantizes to f32
    qf, kf, v = _expanded_attention(q_nope, q_rope, view["ckv"].to(x.dtype),
                                    view["krope"].to(x.dtype), p, n_heads, cfg)
    out = L.chunked_attention(qf, kf, v, q_offset=starts, chunk=chunk)[..., : cfg.v_head_dim]
    return L.matmul(out.reshape(b, csz, n_heads * cfg.v_head_dim), p["w_o"])


def mla_decode(x, p, n_heads: int, cfg: MLAConfig, cache: dict, pos,
               rope_theta: float = 10000.0, layout=None, tables=None):
    """One decode step of one layer: x ``(B, 1, d)``, ``pos`` ``(B,)`` the
    new token's position.  Writes the new latent into ``cache`` (one
    layer's ``{"ckv", "krope"}``) in place and returns ``(B, 1, d)``."""
    b = x.shape[0]
    nd, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c_new, kr_new = _qkv_rope(x, p, n_heads, cfg, pos[:, None], rope_theta)
    layout.write(cache, {"ckv": c_new[:, 0], "krope": kr_new[:, 0]}, pos, tables)
    if layout.kind == "paged" or layout.split() > 1:
        return _absorbed_decode(q_nope, q_rope, p, n_heads, cfg, cache, pos, layout, tables)
    qf, kf, v = _expanded_attention(q_nope, q_rope, cache["ckv"], cache["krope"], p,
                                    n_heads, cfg)
    out = L.decode_attention(qf, kf, v, pos + 1)[..., :vd]
    return L.matmul(out.reshape(b, 1, n_heads * vd), p["w_o"])


def _absorbed_decode(q_nope, q_rope, p, n_heads: int, cfg: MLAConfig, cache: dict, pos,
                     layout, tables):
    """The absorbed decode attention of one layer and ``w_o`` (module
    docstring): over the pool through K2m/K2q or K3's MLA form, over a
    rank's rows of a split slab through the plain stats form and the
    combine."""
    b = q_nope.shape[0]
    nd, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    wk, wv = _absorbed_ukv(p, n_heads, cfg)
    own = wk.shape[1] < n_heads  # this rank's heads of a head-sharded w_ukv
    h0, h1 = sharded.own_range(n_heads) if own else (0, n_heads)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0, h0:h1].float(), wk.float())
    if own:
        q_lat = sharded.all_gather(q_lat, dim=1)
    q_rope = q_rope[:, 0].float()  # (B, H, rd)
    if layout.kind == "paged":
        scales = (dict(k_scale=layout.pool_view(cache["ckv_scale"]),
                       k2_scale=layout.pool_view(cache["krope_scale"])) if layout.quant else {})
        kernel = sharded.paged_attn_sharded if layout.shards > 1 else paged_attn
        o_lat = kernel(
            q_lat[:, None].contiguous(),  # (B, 1, H, kv_lora): Hkv = 1, G = H
            layout.pool_view(cache["ckv"])[:, :, None, :], None, tables["full"], pos + 1,
            scale=(nd + rd) ** -0.5, q2=q_rope[:, None].contiguous(),
            k2_pages=layout.pool_view(cache["krope"])[:, :, None, :], v_is_k=True, **scales,
        )[:, 0]  # (B, H, kv_lora) f32
    else:  # this rank's rows of the split slab: one latent "head" shared by all
        ckv = cache["ckv"][:, :, None]
        rows = torch.cat([ckv, cache["krope"][:, :, None]], -1)  # (B, S/S_ranks, 1, lora + rd)
        acc, m, l = L.decode_attention_stats(
            torch.cat([q_lat, q_rope], -1)[:, None], rows, ckv,
            layout.valid_rows(pos, ckv.shape[1]), scale=(nd + rd) ** -0.5)
        o_lat = sharded.combine_stats(acc, m, l)
    out = torch.einsum("bhl,lhv->bhv", o_lat[:, h0:h1], wv.float()).to(q_nope.dtype)
    out = out.reshape(b, 1, (h1 - h0) * vd)
    return L.matmul_own(out, p["w_o"]) if own else L.matmul(out, p["w_o"])
