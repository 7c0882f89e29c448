"""Multi-head Latent Attention, DeepSeek-V2 (counterpart of ``repro/models/mla.py``).

MLA compresses K/V into a shared latent ``c_kv`` (``kv_lora`` wide) plus one
small RoPE key shared by the heads; per-head K(nope)/V are up-projected from
the latent by ``w_ukv``.  Decode caches only ``(c_kv, k_rope)``.

Decode takes one of two routes, by layout:

- **Slab**: the reference route (``mla.py:239-255``): write the new latent,
  expand the whole latent view to per-head K/V with ``w_ukv`` and attend.
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
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.kernels.paged_attn import paged_attn
from repro_torch.models import layers as L
from repro_torch.sparse_infer.compress import CompressedTensor


def _project_qkv(x, p, n_heads: int, cfg: MLAConfig):
    b, s, _ = x.shape
    q = L.matmul(x, p["w_q"]).reshape(b, s, n_heads, cfg.nope_head_dim + cfg.rope_head_dim)
    dkv = L.matmul(x, p["w_dkv"])  # (B, S, kv_lora + rd)
    return q, dkv[..., : cfg.kv_lora], dkv[..., cfg.kv_lora:]


def _expand_kv(c_kv, p, n_heads: int, cfg: MLAConfig):
    b, s, _ = c_kv.shape
    nd, vd = cfg.nope_head_dim, cfg.v_head_dim
    ukv = L.matmul(c_kv, p["w_ukv"]).reshape(b, s, n_heads, nd + vd)
    return ukv[..., :nd], ukv[..., nd:]  # k_nope, v


def _absorbed_ukv(p, n_heads: int, cfg: MLAConfig):
    """``(W_uk, W_uv)`` as ``(kv_lora, H, nd)`` / ``(kv_lora, H, vd)``; a
    compressed ``w_ukv`` is decompressed here, in the step."""
    w = p["w_ukv"]
    wd = w.dense() if isinstance(w, CompressedTensor) else w
    nd = cfg.nope_head_dim
    wd = wd.reshape(cfg.kv_lora, n_heads, nd + cfg.v_head_dim)
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
    rd = cfg.rope_head_dim
    k_nope, v = _expand_kv(ckv, p, n_heads, cfg)
    kf = torch.cat([k_nope, krope[:, :, None, :].expand(b, s, n_heads, rd)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    v = torch.nn.functional.pad(v, (0, cfg.nope_head_dim + rd - cfg.v_head_dim))
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
    if layout.kind == "paged":
        wk, wv = _absorbed_ukv(p, n_heads, cfg)
        q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(), wk.float())
        scales = (dict(k_scale=layout.pool_view(cache["ckv_scale"]),
                       k2_scale=layout.pool_view(cache["krope_scale"])) if layout.quant else {})
        o_lat = paged_attn(
            q_lat[:, None].contiguous(),  # (B, 1, H, kv_lora): Hkv = 1, G = H
            layout.pool_view(cache["ckv"])[:, :, None, :], None, tables["full"], pos + 1,
            scale=(nd + rd) ** -0.5, q2=q_rope[:, 0].float()[:, None].contiguous(),
            k2_pages=layout.pool_view(cache["krope"])[:, :, None, :], v_is_k=True, **scales,
        )  # (B, 1, H, kv_lora) f32
        out = torch.einsum("bhl,lhv->bhv", o_lat[:, 0], wv.float()).to(x.dtype)
        return L.matmul(out.reshape(b, 1, n_heads * vd), p["w_o"])
    qf, kf, v = _expanded_attention(q_nope, q_rope, cache["ckv"], cache["krope"], p,
                                    n_heads, cfg)
    out = L.decode_attention(qf, kf, v, pos + 1)[..., :vd]
    return L.matmul(out.reshape(b, 1, n_heads * vd), p["w_o"])
