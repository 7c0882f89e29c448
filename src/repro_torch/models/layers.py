"""Shared layers (counterpart of ``repro/models/layers.py``).

Matmul weights are stored ``(in, out)`` (``y = x @ W``), so N:M groups run
along axis 0, the reduction axis.  :func:`matmul` is the one dispatch point
between dense weights (``torch.matmul``) and ``CompressedTensor`` leaves,
which go through the ``nm_spmm`` kernel and are never decompressed.
"""
from __future__ import annotations

from itertools import accumulate
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import sharded
from repro_torch.kernels.nm_spmm import nm_spmm, nm_spmm_batched
from repro_torch.sparse_infer.compress import CompressedTensor

Weight = Union[torch.Tensor, CompressedTensor]
_NEG = -1e30  # finite -inf stand-in for masked scores


def matmul(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """``y = x @ w`` for a dense or an N:M-compressed weight.

    A 2-D compressed weight takes any ``(..., K)`` activation; a stacked
    ``(E, K·n/m, O)`` one (MoE experts) takes ``(E, B, K)`` and runs every
    expert in one batched launch, where the reference vmaps the kernel.

    One rank's shard of a tensor-parallel weight keeps the contract of
    replicated activations in and out (the reference's ``shard_map``
    in/out specs): an output-sharded shard (``oshards``) runs K1 on its
    columns and all-gathers them; a reduction-sharded one (``rshards``)
    takes the rank's K-slice of ``x`` through ``sharded.nm_spmm_sharded``,
    and a reduction-sharded expert stack (the reference serves MoE stacks
    so) through ``sharded.nm_spmm_batched_sharded``."""
    if not isinstance(w, CompressedTensor):
        return x @ w
    nd = w.values.dim()
    if (nd not in (2, 3) or w.group_axis % nd != nd - 2 or (nd == 3 and x.dim() != 3)
            or (nd == 3 and w.oshards > 1)):
        raise ValueError(
            f"unsupported compressed matmul: x {tuple(x.shape)} @ values "
            f"{tuple(w.values.shape)} grouped along axis {w.group_axis}"
        )
    if nd == 3:
        route = sharded.nm_spmm_batched_sharded if w.rshards > 1 else nm_spmm_batched
        return route(x.contiguous(), w.values, w.indices, w.n, w.m, o_true=w.out_features)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if w.oshards > 1:
        y = sharded.all_gather(nm_spmm(x2, w.values, w.indices, w.n, w.m))
        y = y[:, : w.out_features]
    elif w.rshards > 1:
        y = sharded.nm_spmm_sharded(x2, w.values, w.indices, w.n, w.m, o_true=w.out_features)
    else:
        y = nm_spmm(x2, w.values, w.indices, w.n, w.m, o_true=w.out_features)
    return y.reshape(lead + (w.out_features,))


def matmul_cols(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """``x @ w`` for a replicated ``x``, keeping only this rank's output
    columns of an output-sharded weight (``oshards``: no gather); any other
    weight gives its whole output (:func:`matmul`)."""
    if not (isinstance(w, CompressedTensor) and w.oshards > 1):
        return matmul(x, w)
    if w.pad or w.values.dim() != 2:
        raise ValueError("matmul_cols takes an unpadded 2-D output-sharded leaf")
    y = nm_spmm(x.reshape(-1, x.shape[-1]).contiguous(), w.values, w.indices, w.n, w.m)
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


def matmul_own(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """``y = x_full @ w`` where ``x`` holds only this rank's part of the
    replicated activation ``x_full``: its model-axis slice of the last
    axis, in rank order (the rank's own heads).  A weight sharded on that
    same reduction slice (``rshards``) takes ``x`` as it is
    (``sharded.nm_spmm_sharded(local=True)``: no gather); any other weight
    takes the ranks' slices gathered first."""
    if isinstance(w, CompressedTensor) and w.rshards > 1 and w.values.dim() == 2:
        lead = x.shape[:-1]
        y = sharded.nm_spmm_sharded(x.reshape(-1, x.shape[-1]), w.values, w.indices, w.n,
                                    w.m, o_true=w.out_features, local=True)
        return y.reshape(lead + (w.out_features,))
    return matmul(sharded.all_gather(x), w)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 with a ``(1 + scale)`` gain, cast back to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with the biased variance, cast back to ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Half-split (not interleaved) rotary embedding in f32.
    x: (B, S, H, D); positions: (B, S)."""
    return _rotate(x, positions[..., None].float() * _freqs(x.shape[-1], theta, x.device))


def _freqs(d: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the halves of x (B, S, H, D) by the angles ang (B, S, D/2)."""
    d = x.shape[-1]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mrope_sections(d: int, sections=(2, 3, 3)) -> list[int]:
    """How many of the ``d // 2`` rotary frequencies follow each position
    stream (temporal, height, width), in that order: ``sections`` are the
    streams' relative shares, the last taking the remainder (16/24/24 at
    D 128, 2/3/3 at D 16)."""
    half, tot = d // 2, sum(sections)
    splits = [half * s // tot for s in sections]
    splits[-1] = half - sum(splits[:-1])
    return splits


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections=(2, 3, 3),
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: :func:`apply_rope`'s half-split rotation
    in f32, each frequency's angle taken from its own position stream
    (:func:`mrope_sections`).  x: (B, S, H, D); positions: (B, S, 3) int
    (temporal, height, width).  With the same position in all three
    streams it is :func:`apply_rope` bit for bit.  The stream of each
    frequency is made on the device (no host copy: a captured decode
    graph runs it)."""
    d = x.shape[-1]
    freq = torch.arange(d // 2, device=x.device)
    stream = sum((freq >= b).long() for b in accumulate(mrope_sections(d, sections)[:-1]))
    return _rotate(x, positions.float().index_select(-1, stream) * _freqs(d, theta, x.device))


def _per_row(x, device) -> torch.Tensor:
    """A scalar or a ``(B,)`` tensor as ``(B|1, 1)``, for per-row offsets."""
    if isinstance(x, torch.Tensor):
        return x.to(device).reshape(-1, 1)
    return torch.full((1, 1), int(x), device=device)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: Optional[int] = None, q_offset=0, kv_valid_from=0,
                      chunk: int = 512) -> torch.Tensor:
    """Causal attention with an online softmax over KV chunks of ``chunk``,
    so no more than a (Sq, chunk) score block exists per head.
    q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D); GQA groups H // Hkv query heads
    per KV head.  ``window`` (sliding-window attention) keeps the keys at
    ``kv_pos > q_pos - window``: each query sees its last ``window``
    positions.  ``q_offset`` is the kv position of ``q[:, 0]`` and
    ``kv_valid_from`` the first kv slot that may be attended, each a scalar
    or one per row ``(B,)``: batched chunked prefill runs every lane's
    chunk at its own position, and a windowed chunk view masks the slots
    it gathered from below position 0."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    q_pos = _per_row(q_offset, q.device) + torch.arange(sq, device=q.device)  # (B|1, Sq)
    valid_from = _per_row(kv_valid_from, q.device)[:, :, None]  # (B|1, 1, 1)
    m = torch.full((b, hkv, g, sq), _NEG, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
    for c0 in range(0, sk, chunk):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        kv_pos = c0 + torch.arange(kb.shape[1], device=q.device)
        mask = kv_pos <= q_pos[:, :, None]  # (B|1, Sq, chunk)
        if window is not None:
            mask = mask & (kv_pos > q_pos[:, :, None] - window)
        mask = (mask & (kv_pos >= valid_from))[:, None, None]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb) * d ** -0.5
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * mask
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1)
        acc = corr[..., None] * acc + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]  # (B, Hkv, G, Sq, D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor) -> torch.Tensor:
    """Single-token attention over a slab cache.
    q: (B, 1, H, D); caches (B, S, Hkv, D); cache_len (B,) valid prefix."""
    b, s, hkv, d = k_cache.shape
    h = q.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * d ** -0.5
    valid = torch.arange(s, device=q.device)[None, :] < cache_len.reshape(-1, 1)
    scores = scores.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_stats(q: torch.Tensor, k_rows: torch.Tensor, v_rows: torch.Tensor,
                           valid: torch.Tensor, scale: Optional[float] = None):
    """:func:`decode_attention` before its divide, over the rows a rank
    holds of a sequence-sharded slab: the f32 flash triple ``(acc (B, H,
    Dv), m (B, H), l (B, H))`` over the rows where ``valid`` ((B, S_rank)
    bool), for ``kernels.sharded.combine_stats``.  A lane with no valid
    row here gives ``(0, -1e30, 0)``.  q: (B, 1, H, D); rows (B, S_rank,
    Hkv, D|Dv); ``scale`` defaults to ``D ** -0.5``."""
    b, s, hkv, d = k_rows.shape
    h = q.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_rows.float()) * (scale or d ** -0.5)
    mask = valid[:, None, None, :]
    scores = torch.where(mask, scores, _NEG)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None]) * mask
    acc = torch.einsum("bhgs,bshd->bhgd", p, v_rows.float())
    return acc.reshape(b, h, -1), m.reshape(b, h), p.sum(dim=-1).reshape(b, h)


def swiglu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``w_down(silu(w_gate(x)) * w_up(x))``, the product in f32."""
    gate = F.silu(matmul(x, p["w_gate"]).float())
    up = matmul(x, p["w_up"]).float()
    return matmul((gate * up).to(x.dtype), p["w_down"])


def gelu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``w_proj(gelu_tanh(w_fc(x)))`` — the reference's ``approximate=True``."""
    h = matmul(x, p["w_fc"])
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return matmul(h, p["w_proj"])
