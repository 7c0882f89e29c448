"""Per-request token sampling (counterpart of ``repro/serving/sampling.py``).

Each lane carries its own ``(temperature, top_k)``; ``temperature == 0`` is
greedy and ``top_k == 0`` disables the filter.  A sampled draw is keyed by
(engine seed, request uid, generated-token index), as the reference's
``request_keys`` is, so a request's stream does not depend on its lane,
its batch-mates or how dispatches were cut.  The keys are computed on the
device from ``(uids, counts)`` tensors (:func:`draw_keys`), and each row's
uniforms from its key and the vocabulary index by a counter-based 32-bit
hash (:func:`_uniforms`): no host work, so the draws run inside a captured
CUDA graph of the decode loop.  They do not reproduce JAX's bits.  A
stream tag (``draw_keys(..., tag=)``) separates independent streams of one
(request, token index), as the reference's ``fold_in(key, tag)`` does:
plain decode draws on tag 0, speculative decoding's drafter on 1, its
accept uniforms on 2 and its residual draws on 3.

:func:`filtered_probs` and :func:`spec_accept` are speculative decoding's
rejection rule (the reference's): the post-filter distribution a sampled
draw takes, and the accept/reject of a round's drafts against the
verifier's distributions, greedy longest-prefix acceptance where every row
is greedy.

:func:`advance_stops` is the device half of stop handling inside a K-step
dispatch: finished lanes freeze until the host replays the same rules.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_M32 = 0xFFFFFFFF
_PHI32 = 0x9E3779B1  # 2^32 / golden ratio, odd


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding policy."""

    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0  # 0 = no top-k filtering
    max_new_tokens: int = 32
    eos_id: int = -1  # -1 = never stop on a token


def _mul32(x, c: int):
    """``x * c`` modulo 2^32 for int64 ``x`` in [0, 2^32) and ``c`` < 2^32,
    in two 16-bit halves so that no product passes 2^48."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    """MurmurHash3's 32-bit finalizer, a bijection of [0, 2^32); ``x`` an
    int64 tensor or a Python int."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def draw_keys(seed: int, uids: torch.Tensor, counts: torch.Tensor,
              tag: int = 0) -> torch.Tensor:
    """Per-row 32-bit draw keys, int64 ``(B,)``: a hash of (engine seed,
    request uid, generated-token index), computed where ``uids`` lie.  A
    ``tag`` > 0 selects another stream, independent of tag 0's (tag 0 is
    plain decode's, and its keys do not depend on the tag's code)."""
    s = _fmix32(_fmix32((seed >> 32) & _M32) ^ (seed & _M32))
    if tag:
        s = _fmix32(s ^ _mul32(tag & _M32, _PHI32))
    k = _fmix32((uids.long() & _M32) ^ s)
    return _fmix32(k ^ (counts.long() & _M32))


def _uniforms(keys: torch.Tensor, v: int) -> torch.Tensor:
    """``(B, V)`` f32 uniforms in (0, 1), one per (row key, vocabulary
    index): two hash rounds of the index and the key, the top 24 bits
    (exact in f32) centred in their bin."""
    idx = torch.arange(v, device=keys.device, dtype=torch.int64)
    k = keys[:, None]
    h = _fmix32(_mul32(idx, _PHI32)[None, :] ^ k)
    h = _fmix32((h + k) & _M32)
    return ((h >> 8).float() + 0.5) * 2.0 ** -24


def sample_tokens(
    logits: torch.Tensor,  # (B, V)
    temperature: torch.Tensor,  # (B,) f32; 0 = greedy
    top_k: torch.Tensor,  # (B,) int; 0 = disabled
    keys: Optional[torch.Tensor] = None,  # (B,) draw_keys, if sampling
    *,
    need_sample: bool = True,  # False: every row is greedy
    need_topk: bool = True,  # False: no row filters by top-k
) -> torch.Tensor:
    """One token per row under per-row (temperature, top_k).  The ``need_*``
    flags let an all-greedy batch skip the sort and the draws.  A sampled
    row takes the Gumbel-max of its filtered, scaled logits under the
    uniforms of its key."""
    lf = logits.float()
    v = lf.shape[-1]
    if need_topk:
        sorted_desc = torch.sort(lf, dim=-1, descending=True).values
        kth = sorted_desc.gather(1, (top_k.long() - 1).clamp(0, v - 1)[:, None])
        lf = lf.masked_fill((top_k[:, None] > 0) & (lf < kth), float("-inf"))
    greedy = lf.argmax(dim=-1).to(torch.int32)  # first index among equal maxima
    if not need_sample:
        return greedy
    scaled = lf / torch.where(temperature > 0, temperature, 1.0)[:, None]
    gumbel = -torch.log(-torch.log(_uniforms(keys, v)))
    sampled = (scaled + gumbel).argmax(dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


def filtered_probs(
    logits: torch.Tensor,  # (..., V)
    temperature: torch.Tensor,  # (...,) f32; 0 = greedy
    top_k: torch.Tensor,  # (...,) int; 0 = disabled
    *,
    need_topk: bool = True,  # False: no row filters by top-k
) -> torch.Tensor:
    """The distribution a sampled draw of :func:`sample_tokens` takes, per
    row: the same top-k cut, temperature scaling and a softmax; a row at
    ``temperature == 0`` is the one-hot of its (filtered) argmax, so that
    :func:`spec_accept`'s rejection rule reduces to greedy longest-prefix
    acceptance there."""
    lf = logits.float()
    v = lf.shape[-1]
    if need_topk:
        sorted_desc = torch.sort(lf, dim=-1, descending=True).values
        kth = sorted_desc.gather(-1, (top_k.long() - 1).clamp(0, v - 1)[..., None])
        lf = lf.masked_fill((top_k[..., None] > 0) & (lf < kth), float("-inf"))
    one_hot = torch.nn.functional.one_hot(lf.argmax(dim=-1), v).float()
    safe_t = torch.where(temperature > 0, temperature, 1.0)
    probs = torch.softmax(lf / safe_t[..., None], dim=-1)
    return torch.where((temperature > 0)[..., None], probs, one_hot)


def spec_accept(
    drafts: torch.Tensor,  # (B, G) drafter proposals
    p_draft: Optional[torch.Tensor],  # (B, G, V) drafter filtered probs, zero at slots >= gi
    p_verify: torch.Tensor,  # (B, G+1, V) verifier filtered probs; slot j scores the
    #     token after input j, slot G the bonus position
    gi: torch.Tensor,  # (B,) drafts actually proposed per lane
    accept_keys: Optional[torch.Tensor] = None,  # (B,) draw_keys of the accept uniforms
    resid_keys: Optional[torch.Tensor] = None,  # (B,) draw_keys of the residual draw
    *,
    need_sample: bool = True,  # False: every row is greedy (p_draft and keys unused)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The speculative accept/reject rule over the batch; returns
    ``(tokens (B, G+1) int32, n_acc (B,) int32)``: row ``i`` holds the
    ``n_acc[i]`` accepted drafts, then one verifier token (the correction
    at the first rejection, the bonus on full acceptance), then zeros.

    Greedy: the longest prefix of drafts equal to the verifier's argmax,
    then the argmax at the first mismatch or the bonus slot, so the stream
    is plain greedy decoding under the verifier.  Sampled: draft ``j`` is
    accepted with ``u < min(1, p_v(d_j) / p_d(d_j))``; the trailing token
    draws from ``normalize(max(p_v - p_d, 0))`` at slot ``n_acc``, where
    ``p_d`` is zero-padded at the bonus slot (so a full acceptance draws
    from ``p_v``), by a Gumbel-max over its log.  The emitted distribution
    is the verifier's whatever the drafter proposed."""
    b, g = drafts.shape
    drafts = drafts.long()
    proposed = torch.arange(g, device=drafts.device)[None, :] < gi[:, None]
    if not need_sample:
        v_top = p_verify.argmax(dim=-1)  # (B, G+1)
        acc = proposed & (drafts == v_top[:, :g])
        n = acc.long().cumprod(dim=1).sum(dim=1)
        fix = v_top.gather(1, n[:, None])[:, 0]
    else:
        u = _uniforms(accept_keys, g)  # (B, G)
        p_d_at = p_draft.gather(-1, drafts[..., None])[..., 0]
        p_v_at = p_verify[:, :g].gather(-1, drafts[..., None])[..., 0]
        ratio = p_v_at / p_d_at.clamp_min(1e-20)
        acc = proposed & (u < ratio.clamp(max=1.0))
        n = acc.long().cumprod(dim=1).sum(dim=1)
        p_d_pad = torch.cat([p_draft, torch.zeros_like(p_draft[:, :1])], dim=1)
        idx = n[:, None, None].expand(b, 1, p_verify.shape[-1])
        p_v_n = p_verify.gather(1, idx)[:, 0]
        p_d_n = p_d_pad.gather(1, idx)[:, 0]
        resid = (p_v_n - p_d_n).clamp_min(0.0)
        rs = resid.sum(dim=-1, keepdim=True)
        # p_d == p_v empties the residual, but then the accept ratio was 1:
        # the guard only shields rounding dust
        resid = torch.where(rs > 1e-9, resid / rs, p_v_n)
        gumbel = -torch.log(-torch.log(_uniforms(resid_keys, resid.shape[-1])))
        fix = (torch.log(resid) + gumbel).argmax(dim=-1)
    j = torch.arange(g + 1, device=drafts.device)[None, :]
    drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    tokens = torch.where(j < n[:, None], drafts_pad,
                         torch.where(j == n[:, None], fix[:, None], 0))
    return tokens.to(torch.int32), n.to(torch.int32)


def advance_stops(
    tokens: torch.Tensor,  # (B,) freshly sampled
    active: torch.Tensor,  # (B,) bool: lanes decoding this step
    budget: torch.Tensor,  # (B,) tokens each lane may still append
    eos_id: torch.Tensor,  # (B,) per-lane eos (< 0 = never)
    new_len: torch.Tensor,  # (B,) prompt + generated after this append
    max_len: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply one step's stop rules on the device; returns ``(tokens,
    active, budget)`` with finished and idle lanes emitting 0.  Mirrors the
    engine's host-side ``_absorb``: EOS finishes without appending; an
    appended token finishes on an exhausted budget or at capacity."""
    tokens = torch.where(active, tokens, 0)
    eos_hit = active & (eos_id >= 0) & (tokens == eos_id)
    appended = active & ~eos_hit
    budget = budget - appended.to(budget.dtype)
    done = eos_hit | (appended & ((budget <= 0) | (new_len >= max_len)))
    return tokens, active & ~done, budget
