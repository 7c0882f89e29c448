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

:func:`committed_kv_gaps` is the check the stream gate is blind to: a
lane's committed cache entries (after speculative rounds, chunks, a
prefix hit) against those one forward of the verifier over the lane's
tokens produces, position for position.  A rewind off by one or a
drafter's K/V left in a committed slot moves an entry far past f32
rounding while the streams may still agree.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.models.model import forward, read_cache
from repro_torch.sparse_infer.compress import CompressedTensor
from repro_torch.utils.tree import tree_items

# A greedy token may differ from its twin, or from the forward's choice,
# only where the logits lie within this margin.
MARGIN = 0.1


class StreamGateError(AssertionError):
    """Two streams part, or a stream leaves the forward's choice, at a
    margin of at least the gate's."""


def first_difference(a: Sequence[int], b: Sequence[int]) -> int:
    """The first index where ``a`` and ``b`` differ, or ``len(a)``."""
    return next((i for i, (u, v) in enumerate(zip(a, b)) if u != v), len(a))


def tree_device(params: dict) -> torch.device:
    """The device of a parameter tree's leaves (a compressed leaf's values),
    where every forward of the gate runs."""
    leaves = [x.values if isinstance(x, CompressedTensor) else x for _, x in tree_items(params)]
    devices = {t.device for t in leaves}
    if len(devices) != 1:
        raise ValueError(f"the tree's leaves lie on {sorted(map(str, devices))}")
    return devices.pop()


def greedy_gaps(cfg, params: dict, prompts: Sequence[Sequence[int]],
                streams: Sequence[Sequence[int]]) -> list[list[float]]:
    """For each stream, each token's gap: the largest logit less the
    token's, read from one ``forward(params)`` over the prompt and the
    stream's tokens before the last (0 where the token is the greedy
    choice), on the tree's device."""
    device = tree_device(params)
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
                       ) -> tuple[int, int, list[float]]:
    """``(agree, total, margins)``: the tokens equal before each request's
    first difference, the tokens of ``a``, and the top-2 margin at each
    first difference, read from ``forward(params)`` over the prompt and
    the tokens before it, on the tree's device."""
    device = tree_device(params)
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
                  margin: float = MARGIN, greedy: bool = True,
                  ) -> tuple[int, int, list[float], float]:
    """:func:`stream_differences` and, with ``greedy``, the largest of
    :func:`greedy_gaps` over both streams (else 0.0); raises
    :class:`StreamGateError` where a margin at a difference, or a gap, is
    ``margin`` or more."""
    agree, total, margins = stream_differences(cfg, params, prompts, a, b)
    wide = [x for x in margins if x >= margin]
    if wide:
        raise StreamGateError(f"greedy streams differ at top-2 margins {wide} >= {margin} "
                              f"(all margins at differences: {margins})")
    worst = 0.0
    if greedy:
        for name, streams in (("a", a), ("b", b)):
            for r, gaps in enumerate(greedy_gaps(cfg, params, prompts, streams)):
                far = [(i, g) for i, g in enumerate(gaps) if g >= margin]
                if far:
                    raise StreamGateError(
                        f"stream {name} of request {r}: tokens (index, gap) {far} lie "
                        f"{margin} or more below the forward's greedy choice")
                worst = max([worst, *gaps])
    return agree, total, margins, worst


def committed_kv_gaps(cfg, params: dict, cache: dict, layout, tokens: dict) -> dict:
    """For each lane of ``tokens`` (lane -> its committed tokens: the prompt
    and the stream but for its last token, ``len`` entries), the largest
    absolute difference over every attention and MLA layer and position
    below ``len`` between the cached entries (``read_cache``) and those of
    one ``forward(params, want_cache=True)`` over the lanes' tokens (one
    batch, padded at the end: a position's entries see only the tokens
    before it), beside the largest magnitude of the latter: lane ->
    ``{"max_abs", "max_ref"}``.  On int8 pages the served entries of later
    layers were computed from int8 codes of the earlier positions, so they
    differ from the forward's by more than a code step: there the gap is a
    reading.  The forward runs on the tree's device."""
    if not tokens:
        return {}
    device = tree_device(params)
    lanes = list(tokens)
    width = max(len(t) for t in tokens.values())
    batch = torch.tensor([list(tokens[i]) + [0] * (width - len(tokens[i])) for i in lanes],
                         device=device)
    with torch.inference_mode():
        _, want = forward(params, cfg, batch, want_cache=True)
        got = read_cache(cfg, cache, torch.tensor(lanes, device=device), layout)
    # (the sequence axis, the forward's entries, the cached ones) of each
    # layer group: body entries are stacked (L, B, S, ...), the others (B, S, ...)
    groups = [(2, want["body"][k], g) for k, g in got.get("body", {}).items()]
    groups += [(1, want[k], g) for k, g in got.items() if k != "body"]
    out = {}
    for r, lane in enumerate(lanes):
        n = len(tokens[lane])
        rec = {"max_abs": 0.0, "max_ref": 0.0}
        for ax, w_leaves, g_leaves in groups:
            for w, g in zip(w_leaves, g_leaves, strict=True):
                w = w.float().narrow(ax - 1, r, 1).narrow(ax, 0, n)
                g = g.narrow(ax - 1, r, 1).narrow(ax, 0, n)
                rec["max_ref"] = max(rec["max_ref"], w.abs().max().item())
                rec["max_abs"] = max(rec["max_abs"], (g - w).abs().max().item())
        out[lane] = rec
    return out
