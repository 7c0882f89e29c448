"""The serving stream gate: two routes' greedy streams of one traffic,
held to one forward's greedy choices except at near-ties.

Two routes of one engine (the slab and a paged pool, one rank and a mesh)
sum the same products in other orders, so a greedy token may part from
the forward's choice only where the top logits lie within that rounding.
:func:`greedy_gaps` reads, for every token of a stream, how far its logit
lies below the largest, from one ``forward`` of the tree it is given over
the prompt and the stream (each token's logits see exactly the tokens
before it).  :func:`stream_differences` finds each request's first
difference between two streams and reads the top-2 margin there.
:func:`check_streams` raises :class:`StreamGateError` where a margin at a
difference, or (``greedy``) a gap of any token of either stream, reaches
the gate.  The gaps catch a faulty route wherever it leaves the forward's
choice at a clear margin, not only at its first, smallest flip.

The gate holds in f32: the routes are served as f32 twins (the same
compressed tree, every float leaf in f32) and the gaps and margins read
from an f32 forward.  There the routes differ by about 1e-6 of a logit,
so a gap of ``MARGIN`` is a fault of a route, and the bits of a bf16
kernel's order of summation reach neither the streams nor the yardstick.
A route on int8 pages moves its logits by its rounding of K and V, which
the forward does not share: its streams are held to the first
differences alone (``greedy=False``), against a twin on the same pages.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.models.model import forward

# A greedy token may differ from its twin, or from the forward's choice,
# only where the logits lie within this margin.
MARGIN = 0.1


class StreamGateError(AssertionError):
    """Two streams part, or a stream leaves the forward's choice, at a
    margin of at least the gate's."""


def first_difference(a: Sequence[int], b: Sequence[int]) -> int:
    """The first index where ``a`` and ``b`` differ, or ``len(a)``."""
    return next((i for i, (u, v) in enumerate(zip(a, b)) if u != v), len(a))


def greedy_gaps(cfg, params: dict, prompts: Sequence[Sequence[int]],
                streams: Sequence[Sequence[int]], device="cpu") -> list[list[float]]:
    """For each stream, each token's gap: the largest logit less the
    token's, read from one ``forward(params)`` over the prompt and the
    stream's tokens before the last (0 where the token is the greedy
    choice)."""
    out = []
    for p, s in zip(prompts, streams, strict=True):
        if not s:
            out.append([])
            continue
        with torch.inference_mode():
            logits, _ = forward(params, cfg,
                                torch.tensor([list(p) + list(s[:-1])], device=device))
        lg = logits[0, len(p) - 1:].float()
        chosen = lg.gather(-1, torch.tensor(list(s), device=device)[:, None])[:, 0]
        out.append((lg.max(-1).values - chosen).tolist())
    return out


def stream_differences(cfg, params: dict, prompts: Sequence[Sequence[int]],
                       a: Sequence[Sequence[int]], b: Sequence[Sequence[int]],
                       device="cpu") -> tuple[int, int, list[float]]:
    """``(agree, total, margins)``: the tokens equal before each request's
    first difference, the tokens of ``a``, and the top-2 margin at each
    first difference, read from ``forward(params)`` over the prompt and
    the tokens before it."""
    agree, total, margins = 0, 0, []
    for p, x, y in zip(prompts, a, b, strict=True):
        total += len(x)
        j = first_difference(x, y)
        agree += j
        if j == len(x):
            continue
        with torch.inference_mode():
            logits, _ = forward(params, cfg, torch.tensor([list(p) + list(x[:j])], device=device))
        top2 = torch.topk(logits[0, -1].float(), 2).values
        margins.append(float(top2[0] - top2[1]))
    return agree, total, margins


def check_streams(cfg, params: dict, prompts: Sequence[Sequence[int]],
                  a: Sequence[Sequence[int]], b: Sequence[Sequence[int]],
                  margin: float = MARGIN, device="cpu", greedy: bool = True,
                  ) -> tuple[int, int, list[float], float]:
    """:func:`stream_differences` and, with ``greedy``, the largest of
    :func:`greedy_gaps` over both streams (else 0.0); raises
    :class:`StreamGateError` where a margin at a difference, or a gap, is
    ``margin`` or more."""
    agree, total, margins = stream_differences(cfg, params, prompts, a, b, device)
    wide = [x for x in margins if x >= margin]
    if wide:
        raise StreamGateError(f"greedy streams differ at top-2 margins {wide} >= {margin} "
                              f"(all margins at differences: {margins})")
    worst = 0.0
    if greedy:
        for name, streams in (("a", a), ("b", b)):
            for r, gaps in enumerate(greedy_gaps(cfg, params, prompts, streams, device)):
                far = [(i, g) for i, g in enumerate(gaps) if g >= margin]
                if far:
                    raise StreamGateError(
                        f"stream {name} of request {r}: tokens (index, gap) {far} lie "
                        f"{margin} or more below the forward's greedy choice")
                worst = max([worst, *gaps])
    return agree, total, margins, worst
