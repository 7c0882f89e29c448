"""Per-request token sampling (counterpart of ``repro/serving/sampling.py``).

Each lane carries its own ``(temperature, top_k)``; ``temperature == 0`` is
greedy and ``top_k == 0`` disables the filter.  A sampled draw is keyed by
(engine seed, request uid, generated-token index), as the reference's
``request_keys`` is, so a request's stream does not depend on its lane or
on how dispatches were cut.  The draws use ``torch.Generator`` and do not
reproduce JAX's bits.

:func:`advance_stops` is the device half of stop handling inside a K-step
dispatch: finished lanes freeze until the host replays the same rules.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding policy."""

    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0  # 0 = no top-k filtering
    max_new_tokens: int = 32
    eos_id: int = -1  # -1 = never stop on a token


def request_seed(seed: int, uid: int, count: int) -> int:
    """Generator seed of request ``uid``'s ``count``-th generated token."""
    digest = hashlib.blake2b(f"{seed}:{uid}:{count}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def sample_tokens(
    logits: torch.Tensor,  # (B, V)
    temperature: torch.Tensor,  # (B,) f32; 0 = greedy
    top_k: torch.Tensor,  # (B,) int; 0 = disabled
    seeds: Optional[Sequence[int]] = None,  # per-row request_seed, if sampling
    *,
    need_sample: bool = True,  # False: every row is greedy
    need_topk: bool = True,  # False: no row filters by top-k
) -> torch.Tensor:
    """One token per row under per-row (temperature, top_k).  The ``need_*``
    flags let an all-greedy batch skip the sort and the draws."""
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
    sampled = torch.stack([_gumbel_argmax(row, s) for row, s in zip(scaled, seeds)])
    return torch.where(temperature > 0, sampled, greedy)


def _gumbel_argmax(row: torch.Tensor, seed: int) -> torch.Tensor:
    """A categorical draw from ``softmax(row)`` by the Gumbel-max trick."""
    gen = torch.Generator(device=row.device).manual_seed(seed)
    u = torch.rand(row.shape, generator=gen, device=row.device)
    return (row - torch.log(-torch.log(u))).argmax().to(torch.int32)


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
