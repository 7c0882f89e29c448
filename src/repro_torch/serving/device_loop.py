"""The device scheduler's decode loop (counterpart of ``_dloop``,
``repro/serving/engine.py:763-908``).

One iteration is one decode step of every lane: a feeding lane (a request
refilled inside the loop) consumes its prompt token by token from its feed
buffer, a drained lane samples; the stop rules (``advance_stops``) freeze
lanes; then at most one dead lane is refilled from the staged ring (its
table rows installed, its RG-LRU or SSM rows zeroed by ``reset_lanes``, its
``len`` set to 0).  The loop runs while some lane is live or a staged
request waits, up to ``k_loop`` iterations, and stops at a freeze that no
refill covered (``stall``: the host has to schedule).

Every tensor the loop reads or writes has one address for the life of the
engine: the lane vectors, the staged ring and the outputs live in packed
static buffers (:class:`DeviceLoop`), the cache is updated in place.  The
host fills the inputs once a cycle (one host-to-device copy per dtype)
and reads back per dispatch only the token block, the steps taken and the
refills made (``consumed_lane``/``consumed_step``), copied into pinned
buffers of that dispatch.  The state chains on the device from one
dispatch to the next, so a second dispatch (``async_stream``) runs while
the host replays the first.

**On the card** the loop is one ``torch.cuda.CUDAGraph`` per signature
``(k_loop, need_sample, need_topk)``: ``k_loop`` iterations unrolled, each
gated by a device flag ``running``, the while-loop's condition (the
dispatch enabled, no stall, some lane live or a request staged; once
false it stays false).  A gated iteration still launches its kernels,
but commits nothing: ``len``, the RG-LRU or SSM state, the rolling window slab,
the lane vectors, the ring cursor, the block and the refill records keep
their values (``decode_step``'s ``commit``).  Its K/V writes land at each
lane's ``len``, a slot the lane's next real step overwrites before
anything reads it, inside the pages reserved for the write horizon or on
the sink page.  A CUDA 12.4 conditional WHILE node (or an IF node around
each iteration) would skip those iterations, but PyTorch 2.11's capture
records no conditional nodes, and its allocator could not serve a body
graph captured by hand; the unrolled graph keeps every launch on
PyTorch's capture.  The capture is preceded by one gated iteration on a
side stream (PyTorch's warm-up rule: the kernels' shared memory
attributes and the allocator's growth happen outside capture).  The
wrappers count launches on the host, which a replay does not run: the
launches recorded during capture are taken back and added once per
replay (:attr:`DeviceLoop.captured` × :attr:`DeviceLoop.replays`).  A
capture that fails raises; nothing falls back to the eager loop.

**Eager** (``mode="eager"``: always on the CPU, on the card only when a
caller asks for it) runs the same ``k_loop`` gated iterations as plain
PyTorch calls, the plain version the CPU tests use.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.models.model import decode_step, reset_lanes
from repro_torch.serving.sampling import advance_stops, draw_keys, sample_tokens

# the rows of the packed lane state and of the staged ring, in order
LANE_ROWS = ("tok", "live", "occupied", "pend", "fed", "counts", "budget", "uids", "topks",
             "eos")
RING_ROWS = ("len", "uid", "count0", "topks", "eos", "budget")
MODES = ("graph", "eager")


class DeviceLoop:
    """The static buffers of one engine's decode loop, its captured graphs
    and its dispatches.  ``cache`` is the engine's (updated in place);
    ``staged`` ring rows (at least one); ``dispatches`` pinned output
    buffers, one per dispatch of a cycle."""

    def __init__(self, cfg, params: dict, cache: dict, layout, *, lanes: int, max_len: int,
                 staged: int, k_loop: int, dispatches: int, seed: int, mode: str,
                 device: torch.device):
        if mode not in MODES:
            raise ValueError(f"device loop mode must be one of {MODES}, got {mode!r}")
        if mode == "graph" and device.type != "cuda":
            raise ValueError("the graph loop runs on the card; the CPU runs the eager loop")
        self.cfg, self.params, self.cache, self.layout = cfg, params, cache, layout
        self.lanes, self.max_len, self.staged, self.k_loop = lanes, max_len, staged, k_loop
        self.seed, self.mode, self.device = seed, mode, device
        b, s, q = lanes, max_len, staged
        tables = cache.get("tables") or {}
        self.table_keys = sorted(tables)
        ints = [("lanes", (len(LANE_ROWS), b)), ("feed_buf", (b, s)),
                ("ring", (len(RING_ROWS), q)), ("s_tokens", (q, s))]
        ints += [(f"s_tbl_{key}", (q, tables[key].shape[1])) for key in self.table_keys]
        ints.append(("scal", (3,)))  # ring cursor, staged count, enable
        pin = device.type == "cuda"
        self._i, self._ih = _pack(ints, torch.int32, device, pin)
        self._f, self._fh = _pack([("temps", (b,)), ("s_temps", (q,))], torch.float32,
                                  device, pin)
        # per dispatch: the token block, the steps taken, the refills
        outs = [("block", (k_loop, b)), ("steps", (1,)), ("consumed", (2, q))]
        self._o, _ = _pack(outs, torch.int32, device, False)
        self._out_host = [_pack(outs, torch.int32, None, pin)[1] for _ in range(dispatches)]
        self._stall = torch.zeros((), dtype=torch.bool, device=device)
        self._lane_idx = torch.arange(b, device=device)
        self._ring_idx = torch.arange(q, device=device)
        self._events = [torch.cuda.Event() for _ in range(dispatches)] if pin else None
        self._graphs: dict[tuple, torch.cuda.CUDAGraph] = {}
        self.captured: dict[tuple, dict[str, int]] = {}  # launches of one replay, by signature
        self.replays: dict[tuple, int] = {}
        self.iterations = 0  # iterations run on the device, replayed or eager
        self.warmup_iterations = 0
        self.capture_s = 0.0  # host seconds in warm-ups and captures

    # -- host side -----------------------------------------------------------

    def load(self, **fields: np.ndarray) -> None:
        """Write the cycle's inputs (every field of the lane state, the
        ring, the staged table rows and ``scal``: ring cursor, staged
        count, enable) into the host buffers and copy them to the device,
        one copy per dtype."""
        for name, value in fields.items():
            (self._ih if name in self._ih else self._fh)[name][...] = value
        for dev, host in ((self._i, self._ih), (self._f, self._fh)):
            dev["_flat"].copy_(host["_flat"], non_blocking=True)

    def prepare(self, sig: tuple) -> None:
        """Capture the graph of signature ``(k_loop, need_sample,
        need_topk)`` if it is new (the graph loop), so that no dispatch
        pays for its capture; its seconds go to :attr:`capture_s`."""
        if self.mode == "graph" and sig not in self._graphs:
            t0 = time.perf_counter()
            self._graphs[sig] = self._capture(sig)
            torch.cuda.synchronize(self.device)
            self.capture_s += time.perf_counter() - t0

    def dispatch(self, w: int, sig: tuple) -> None:
        """Run one dispatch of signature ``sig``: a replay of its graph
        (:meth:`prepare` captures it) or the eager iterations; then copy
        its outputs into dispatch ``w``'s host buffers behind an event."""
        if self.mode == "eager":
            self._body(sig, self.k_loop)
        else:
            self.prepare(sig)
            self._graphs[sig].replay()
            for name, n in self.captured[sig].items():
                dispatch.launches[name] += n
            self.replays[sig] += 1
        self.iterations += self.k_loop
        out = self._out_host[w]["_flat"]
        out.copy_(self._o["_flat"], non_blocking=True)
        if self._events is not None:
            self._events[w].record()

    def fetch(self, w: int) -> tuple[np.ndarray, int, np.ndarray, np.ndarray]:
        """Dispatch ``w``'s outputs once its copy is done: the ``(k_loop,
        B)`` token block, the steps it took, and per ring row the lane it
        refilled and the iteration (-1: not consumed)."""
        if self._events is not None:
            self._events[w].synchronize()
        h = self._out_host[w]
        return h["block"], int(h["steps"][0]), h["consumed"][0], h["consumed"][1]

    # -- the loop ------------------------------------------------------------

    def _capture(self, sig: tuple) -> torch.cuda.CUDAGraph:
        cur = torch.cuda.current_stream(self.device)
        scal = self._i["scal"]
        scal[2].fill_(0)  # the warm-up iteration is gated: it changes nothing
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._body(sig, 1)
        cur.wait_stream(side)
        scal[2].fill_(1)
        self.warmup_iterations += 1
        before = dict(dispatch.launches)
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(g):
                self._body(sig, self.k_loop)
        except RuntimeError as e:
            raise RuntimeError(f"capture of the decode loop {sig} failed (no eager "
                               f"fallback on the card): {e}") from e
        finally:  # the capture launched nothing: take its counts back
            self.captured[sig] = {k: dispatch.launches[k] - n for k, n in before.items()
                                  if dispatch.launches[k] != n}
            dispatch.launches.update(before)
        self.replays[sig] = 0
        return g

    def _body(self, sig: tuple, iterations: int) -> None:
        """One dispatch: its outputs reset, then ``iterations`` gated
        iterations (a graph holds ``k_loop``, the warm-up one)."""
        _, need_sample, need_topk = sig
        self._o["block"].zero_()
        self._o["steps"].zero_()
        self._o["consumed"].fill_(-1)
        self._stall.zero_()
        for i in range(iterations):
            self._iteration(i, need_sample, need_topk)

    def _iteration(self, i: int, need_sample: bool, need_topk: bool) -> None:
        """Iteration ``i`` of a dispatch, committed only where ``running``."""
        cache, b, s, q = self.cache, self.lanes, self.max_len, self.staged
        lanes, scal = self._i["lanes"], self._i["scal"]
        tok, live, occ, pend, fed, counts, budget, uids, topks, eos = lanes.unbind(0)
        temps = self._f["temps"]
        live_b, occ_b = live > 0, occ > 0
        s_next, s_avail = scal[0], scal[1]
        # the while-loop's condition; once false it stays false, since a
        # gated iteration changes nothing it reads
        run = (scal[2] > 0) & ~self._stall & (live_b.any() | (s_next < s_avail))
        # feed or sample: a feeding lane consumes its prompt token by token
        feeding = pend > 0
        fed_tok = self._i["feed_buf"].gather(1, fed.clamp(0, s - 1).long()[:, None])[:, 0]
        len_prev = cache["len"].clone()
        logits, _ = decode_step(self.params, self.cfg, torch.where(feeding, fed_tok, tok),
                                cache, self.layout, commit=run.expand(b))
        length = torch.where(live_b, cache["len"], torch.where(occ_b, len_prev, 0))
        pend = torch.where(feeding, pend - 1, pend)
        fed = fed + feeding.int()
        # a lane samples the step its prompt drains: the feed of its last
        # prompt token is its first-token forward
        sample_now = live_b & (pend == 0)
        keys = draw_keys(self.seed, uids, counts) if need_sample else None
        nxt = sample_tokens(logits, temps, topks, keys, need_sample=need_sample,
                            need_topk=need_topk)
        counts = counts + sample_now.int()
        out, act, budget = advance_stops(nxt, sample_now, budget, eos, length, self.max_len)
        tok = torch.where(sample_now, out, tok)
        froze = sample_now & ~act
        live_b = act | (pend > 0)
        occ_b = occ_b | froze
        # at most one refill: the first dead lane takes the next staged request
        free = ~live_b
        do = run & (s_next < s_avail) & free.any()
        lane = free.int().argmax()
        row = s_next.clamp(0, q - 1).long().reshape(1)
        lm = (self._lane_idx == lane) & do
        s_len, s_uid, s_count0, s_topks, s_eos, s_budget = (
            self._i["ring"].index_select(1, row)[:, 0].unbind(0))
        uids = torch.where(lm, s_uid, uids)
        temps = torch.where(lm, self._f["s_temps"].index_select(0, row), temps)
        topks = torch.where(lm, s_topks, topks)
        eos = torch.where(lm, s_eos, eos)
        budget = torch.where(lm, s_budget, budget)
        counts = torch.where(lm, s_count0, counts)
        pend = torch.where(lm, s_len, pend)
        fed = torch.where(lm, 0, fed)
        feed_buf = self._i["feed_buf"]
        feed_buf.copy_(torch.where(lm[:, None], self._i["s_tokens"].index_select(0, row),
                                   feed_buf))
        for key in self.table_keys:
            t = cache["tables"][key]
            t.copy_(torch.where(lm[:, None], self._i[f"s_tbl_{key}"].index_select(0, row), t))
        length = torch.where(lm, 0, length)
        reset_lanes(self.cfg, cache, lm)
        live_b, occ_b = live_b | lm, occ_b | lm
        hit = (self._ring_idx == row) & do
        consumed = self._o["consumed"]
        consumed[0].copy_(torch.where(hit, lane.int(), consumed[0]))
        consumed[1].copy_(torch.where(hit, i, consumed[1]))
        # commit where the iteration ran; a refill and a freeze it did not
        # cover are already gated by ``do``
        cache["len"].copy_(torch.where(run, length, len_prev))
        new = torch.stack([tok, live_b.int(), occ_b.int(), pend, fed, counts, budget, uids,
                           topks, eos])
        lanes.copy_(torch.where(run, new, lanes))
        self._f["temps"].copy_(torch.where(run, temps, self._f["temps"]))
        block = self._o["block"][i]
        block.copy_(torch.where(run, out, block))
        scal[:1].add_(do.int())
        self._o["steps"].add_(run.int())
        self._stall.copy_(self._stall | (run & (froze & ~lm).any()))


def _pack(fields, dtype, device, pin: bool):
    """One flat buffer holding every field: ``(views, host views)``, the
    device views ``{name: tensor}`` (None without a ``device``) and the
    numpy views of a host twin (pinned where ``pin``); each dict holds the
    flat tensor itself under ``"_flat"``."""
    total = sum(math.prod(shape) for _, shape in fields)
    flat = (torch.zeros(total, dtype=dtype, device=device) if device is not None else None)
    host = torch.zeros(total, dtype=dtype, pin_memory=pin)
    views, hviews, at = {"_flat": flat}, {"_flat": host}, 0
    for name, shape in fields:
        n = math.prod(shape)
        if flat is not None:
            views[name] = flat[at:at + n].view(shape)
        hviews[name] = host[at:at + n].view(shape).numpy()
        at += n
    return views, hviews
