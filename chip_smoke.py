#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``.
Phases, in order; any failure exits non-zero:

1. Device: print the card's ``nvidia-smi`` name and power limit; build the
   CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in
   parallel).
2. Kernels against their plain PyTorch versions, at the shapes the
   full-width gpt2-paper paths give them: ``nm_spmm`` and ``paged_attn`` in
   bf16 within one bf16 rounding step, ``nm_mask`` bit-exact in bf16 and
   f32 (and on ties, all-zero groups, 1:4, 2:8, 4:16); then CUDA-event
   timings of the kernel, the plain version and, where one exists, a
   one-call PyTorch yardstick, beside the least time the card could take
   (the larger of bytes / 3.35 TB/s and operations / 989 TFLOP/s, counted
   from the shapes).  ``nm_spmm`` (K1) runs its decode kernel for B <= 8
   rows (a ring of kept weight rows in flight per lane) and its first
   version's body above, both summing every output in one fixed order:
   every K1 call runs twice and must give the same bytes, and a prefill's
   first rows the bytes of a decode call of those rows alone.  K1 is also
   timed at RecurrentGemma-9B's MLP widths (4096->12288, 12288->4096, B =
   4), with its rate in GB/s.
3. Serve full-width gpt2-paper (random weights from a seed, STEP 2:4
   export, compression) through ``DecodeEngine``: on the slab, then on an
   undersized paged pool that preempts.  Launch counts are zeroed before
   and read after; both kernels must have run.  Every request must finish
   with its token budget, and where the two greedy streams differ the
   top-2 logit margin must be a near-tie.  Then the same traffic on an
   int8 pool (``kv_quant``) of no more device bytes than the fp pool
   (about twice its pages): ``paged_attn``'s int8 form must launch 12
   times per decode step and the fp form never, and the pool must preempt
   fewer times than the fp pool.  Then a ``torch.profiler`` trace of a few
   decode steps on a 28-page fp and int8 pool (device ms a step by kernel).
4. Train full-width gpt2-paper with the STEP recipe through the Trainer
   that ``repro_torch.launch.train`` builds (2:4, batch 8, seq 128,
   b2 0.98, 60 steps, AutoSwitch clipped to (6, 30]), checkpointing to a
   temporary directory.  Loss and gradient norm must stay finite, the loss
   must fall, the switch must land in (t_min, t_max + 1], and ``nm_mask``
   must launch 6 times per masked step plus 6 for the final export; the
   export must be exactly 2:4.  Then a ``torch.profiler`` trace of three
   more steps of each phase gives the device-busy time per step.
5. Serve what was trained: the final checkpoint's params, exported,
   compressed and served greedily (4 requests of 16 + 8 tokens on the
   slab, prompts from the training corpus); ``nm_spmm`` must launch, every
   request must finish, and most generated tokens must lie in the corpus's
   16-symbol alphabet (an untrained model almost never emits them).
6. Serve full-width DeepSeek-V2-Lite (all 27 layers: MLA, 64-expert MoE):
   random weights from seed 0, the STEP 2:4 export and compression leaf by
   leaf, then 8 greedy requests of 64 + 32 tokens over 4 lanes, K = 4, on
   the slab, on a paged pool that never preempts (its streams must equal
   the slab's except at near-ties: top-2 margin under 0.1) and on an
   undersized pool that preempts, then on an int8 pool of the first
   pool's 28 pages.  Launch counts are zeroed before and read after each
   run: the batched ``nm_spmm`` must launch 3 x 26 times per decode step
   and per prefill batch, and ``paged_attn``'s MLA form (its int8 form on
   the int8 pool) 27 times per paged decode step.  Then a
   ``torch.profiler`` trace of a few decode steps on the fp and the int8
   pool.
7. Serve full-width RecurrentGemma-9B (all 38 layers: 12 x (RG-LRU,
   RG-LRU, local MQA) + 2 RG-LRU): random weights from seed 0, the STEP
   2:4 export and compression leaf by leaf, then 4 greedy requests of
   2100, 2032, 1200 and 64 prompt tokens (prefilled at exact lengths) + 48
   generated over 4 lanes, K = 4, max_len 2176 (so the attention layers
   take the 2048-token window: a rolling slab, a modular page table), on
   the slab, on a 520-page pool that never preempts (its streams must
   equal the slab's except at near-ties: top-2 margin under 0.1; it must
   hold only the window table and evict pages), on a 340-page pool that
   preempts and on a 520-page int8 pool (which must evict as the fp one
   does).  ``nm_spmm`` must launch 254 times per decode step and per
   prefill batch, ``paged_attn``'s window form (its int8 form on the int8
   pool) 12 times per paged decode step, and no other attention kernel.  The two decode routes from one
   state past the window must agree within 1e-3 in f32 over the first
   period and the tail (the bf16 difference at full depth is printed as a
   reading).  Then a ``torch.profiler`` trace of a few decode steps on the
   fp and the int8 pool, with the device ms a step of K2w's walk and
   combine and of K1's decode kernel.

Phase 2 also holds the kernels of phases 6 and 7 against their plain
versions at their shapes: the batched ``nm_spmm`` at (64 experts, 8 rows,
2048->1408 and 1408->2048; each call twice, the same bytes), K2's MLA
form (B = 4, 16 heads, latent 512, RoPE 64, ps = 16, ragged lengths up to
96) and its window form (B = 4, 16 query heads over one KV head of 256,
ps = 16, window 2048 over 130 modular slots, lengths 2100/2048/1000/0),
with their times; and K2's int8 form
(K2q) in each of its GQA, MLA and window forms at those shapes, over the
port's own int8 codes and f16 scales of the same random pages (the MLA
form, f32 in and out, to an f32 tolerance), timed beside the bound of the
codes' and scales' bytes and, as a yardstick only, SDPA on the
pre-dequantized bf16 view.  The window form's four variants (fp and int8
pages, normalized and stats flush) run the split walk: each lane's 130
slots over S blocks (``window_splits``; each row carries the S its timed
launch ran with, as the wrapper recorded it), their partials merged by the
combine kernel; each must give the same bytes when called twice, and its
log line names the time of the one-block-per-lane walk it replaced.  The
GQA and MLA forms (K2, K2m, K2q, K3) run a pipelined walk that keeps the
first version's arithmetic: phase 2 first holds every case of
``kernels/paged_attn_check.py`` (both forms x f32/bf16 queries x
f32/bf16/int8 pages x both flushes, at these shapes, the card tests' and
edge shapes, and 256 grid shapes) against the SHA-256 digests of the first version's outputs, then each
such row must give the same bytes when called twice, and its log line
names the first version's time; the GQA and MLA rows also log their time
with every lane at 0, 1, 2, 4 and 7 live pages.

8. Serve full-width gpt2-paper tensor-parallel: two ranks
   (``launch.mesh.run_ranks``, ``gloo`` since they share the one card)
   each keep half the compressed weights, half of ``tok_embed`` and half
   of the pool plus a sink page, and serve phase 3's traffic on its
   22-page fp pool and its 44-page int8 pool, decode attention through
   K3 over each rank's page range and the combine.  Every rank's streams,
   host page tables and one forward's logits must be identical; the
   streams must equal phase 3's single-rank runs except at near-ties
   (top-2 margin under 0.1), with the same preemptions; per rank and
   decode step K3's form of the pool must launch 12 times and no other
   attention kernel at all, K1 72 times per decode step and prefill
   batch, with 98 collectives a decode step.  Prints ms a step, tok/s,
   collectives and the host time inside them, and each rank's weight and
   KV bytes.

Phase 2 also holds K3, the stats flush of ``paged_attn``, in all six
forms (GQA, window, MLA; fp and int8 pages) at K2's, K2w's and K2m's
shapes: ``(acc, m, l)`` against its plain version in f32, dead lanes
exactly ``(0, -1e30, 0)``, then each form's pool split into 2 and 4 page
ranges, K3 on each range and the combine, against K2 on the whole pool;
timed beside its bound and its plain version (no one PyTorch call returns
unnormalized flash stats: SDPA is timed as a yardstick only).  K3's
window forms run K2w's split walk and combine, with the stats flush.  K3's
window and MLA forms run on no serving path yet (tensor-parallel DeepSeek
and RecurrentGemma are later work): their rows show the 0 launches phase
8's ranks count of them.

Every int8 run also prints readings, with no gate: each request's first
generated token against the fp run's (it comes from prefill, which reads
fresh fp K/V), how many greedy tokens agree with the fp run, and the
logit difference of one decode step from one state over int8 and fp
pages.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
# Both the kernel and its plain version round an f32 result to bf16 once;
# f32 results that differ by summation order can round one bf16 step apart,
# and a bf16 step is at most 2^-7 of the value.  ATOL covers outputs near 0.
BF16_RTOL, ATOL = 2.0 ** -7, 1e-5
# f32 results of the same products summed in another order (K2q's MLA form:
# f32 in, f32 math, f32 out)
F32_RTOL = 1e-4
# The window form's times at phase 2's shapes with the one-block-per-lane
# walk the split walk replaced, for the log only (PERF.md §6, PR 16: H100
# 80GB HBM3, 700 W)
WINDOW_EARLIER_MS = {"paged_attn_win": 1.7858, "paged_attn_win_q": 2.3763,
                     "paged_attn_win_stats": 2.0399, "paged_attn_win_stats_q": 2.3269}
# The GQA and MLA forms' times at phase 2's shapes with the first version's
# body, which the pipelined walk replaced with the same bytes, for the log
# only: the earlier times of PERF.md §6's table (H100 80GB HBM3, 700 W),
# not measured by this script
BODY_EARLIER_MS = {"paged_attn": 0.0360, "paged_attn_q": 0.0356, "paged_attn_stats": 0.0353,
                   "paged_attn_stats_q": 0.0358, "paged_attn_mla": 0.1093,
                   "paged_attn_mla_q": 0.1294, "paged_attn_mla_stats": 0.1193,
                   "paged_attn_mla_stats_q": 0.1301}
# the commit whose GQA/MLA kernel wrote the digests of kernels/paged_attn_check.py
FIRST_BODY = "064ba4a"
# live pages a lane at which phase 2 times the GQA and MLA body (log only)
LIVE_PAGES = (0, 1, 2, 4, 7)
# A greedy slab token may differ from its paged twin only at a near-tie:
# bf16 logits (|logit| ~ 1) carry about 2^-8 of rounding per operation, and
# 12 layers of it stay well inside 0.1.
MARGIN = 0.1
# kernel entry -> (its CUDA source, the TPU kernel it replaces)
KERNEL_ROWS = {
    "nm_spmm": ("nm_spmm", "src/repro/kernels/nm_spmm.py:133"),
    "nm_spmm_batched": ("nm_spmm", "src/repro/kernels/nm_spmm.py:133 "
                        "(vmapped over experts at src/repro/models/layers.py:66-74)"),
    "paged_attn": ("paged_attn", "src/repro/kernels/paged_attn.py:190"),
    "paged_attn_mla": ("paged_attn", "src/repro/kernels/paged_attn.py:190 "
                       "(q2/k2_pages/v_is_k, called at src/repro/models/mla.py:222)"),
    "paged_attn_win": ("paged_attn", "src/repro/kernels/paged_attn.py:190 "
                       "(window/win_slots, paged_attn.py:109-125)"),
    "paged_attn_q": ("paged_attn", "src/repro/kernels/paged_attn.py:190 "
                     "(k_scale/v_scale, paged_attn.py:131-134, 159-161)"),
    "paged_attn_win_q": ("paged_attn", "src/repro/kernels/paged_attn.py:190 "
                         "(window/win_slots with k_scale/v_scale, paged_attn.py:109-134, "
                         "159-161)"),
    "paged_attn_mla_q": ("paged_attn", "src/repro/kernels/paged_attn.py:190 "
                         "(q2/k2_pages/v_is_k with k_scale/k2_scale, paged_attn.py:131-142, "
                         "called at src/repro/models/mla.py:222)"),
    "paged_attn_stats": ("paged_attn", "src/repro/kernels/paged_attn.py:190 "
                         "(emit_stats=True, paged_attn.py:171-176, 273-284, 318-320; "
                         "registered as paged_attn_stats at :453-461)"),
    "paged_attn_stats_q": ("paged_attn", "src/repro/kernels/paged_attn.py:190 "
                           "(emit_stats=True with k_scale/v_scale, paged_attn.py:131-134, "
                           "159-161, 171-176)"),
    "paged_attn_win_stats": ("paged_attn", "src/repro/kernels/paged_attn.py:190 "
                             "(emit_stats=True with window/win_slots, paged_attn.py:109-125, "
                             "171-176)"),
    "paged_attn_win_stats_q": ("paged_attn", "src/repro/kernels/paged_attn.py:190 "
                               "(emit_stats=True with window/win_slots and k_scale/v_scale, "
                               "paged_attn.py:109-134, 159-161, 171-176)"),
    "paged_attn_mla_stats": ("paged_attn", "src/repro/kernels/paged_attn.py:190 "
                             "(emit_stats=True with q2/k2_pages/v_is_k, paged_attn.py:171-176; "
                             "per shard at src/repro/kernels/sharded.py:147-155)"),
    "paged_attn_mla_stats_q": ("paged_attn", "src/repro/kernels/paged_attn.py:190 "
                               "(emit_stats=True with q2/k2_pages/v_is_k and k_scale/k2_scale, "
                               "paged_attn.py:131-142, 171-176)"),
    "nm_mask": ("nm_mask", "src/repro/kernels/nm_mask.py:53"),
}
# K3's forms: phase 8 reads each one's launches from its ranks.  The
# window and MLA forms run on no path yet (tensor-parallel serving of
# RecurrentGemma and DeepSeek is later work, ROADMAP.md §1 item 1), so
# their counts read 0
K3_FORMS = tuple(name for name in KERNEL_ROWS if "_stats" in name)
# DeepSeek-V2-Lite's MoE layers (26: layer 0 has a dense MLP), each with 3
# batched nm_spmm launches (gate, up, down), and its layers
DS_MOE_LAYERS, DS_LAYERS = 26, 27
# A DeepSeek slab token may differ from its paged twin only at a near-tie:
# the slab expands K/V through bf16 matmuls, the paged route attends in f32
# latent space, so the logits differ by bf16 rounding carried through the
# layers (and MoE routing flips where it meets a router's near-tie).  A
# fixed gate: every top-2 margin at a difference measured on an H100 lay
# below 0.1 (largest 0.0977).  The routes' bf16 difference from one state
# is printed beside it as a reading, not used as the gate.
DS_MARGIN = MARGIN
# In f32 the two decode routes differ only in summation order (absorbed
# W_uk/W_uv against expanded K/V): about 1e-6 of a logit over 4 layers on
# an H100.
DS_ROUTE_F32_TOL = 1e-3
# RecurrentGemma-9B serving (phase 7): per forward (a prefill batch or a
# decode step) K1 runs 5 RG-LRU projections + 2 MLP matmuls in each of the
# 26 recurrent layers and q/k/v/o + 2 MLP matmuls in each of the 12
# local-attention layers; K2w once per attention layer and paged step.
RG_K1_PER_PASS, RG_ATTN_LAYERS = 26 * 7 + 12 * 6, 12
# prompts past the window (2100), crossing position 2048 while decoding
# (2032), short of it (1200) and short (64); max_len 2176 >= the window, so
# the attention layers take the modular window table
RG_PROMPTS, RG_GEN, RG_MAX_LEN = (2100, 2032, 1200, 64), 48, 2176
# 4 lanes x the 130-slot window table never preempts; 340 pages admit all
# four prompts (338) and run short as the two shorter lanes grow
RG_PAGES, RG_PAGES_PREEMPTING = 520, 340
# A slab token may differ from its paged twin only at a near-tie, as in
# phases 3 and 6; the f32 routes differ only in summation order.
RG_MARGIN, RG_ROUTE_F32_TOL = MARGIN, 1e-3
# the training run of phase 4; the switch is forced at t_max + 1 = 31 since
# the AutoSwitch window (T_w = 50 at b2 = 0.98) is not yet full by then
TRAIN_ARGS = ["--no-smoke", "--recipe", "step", "--nm", "2:4", "--batch", "8", "--seq", "128",
              "--b2", "0.98", "--steps", "60", "--lr", "3e-3", "--ckpt-every", "30"]
# gpt2-paper's maskable leaves, stacked (L, in, out): wq wk wv wo, w_fc, w_proj
MASK_LEAVES = {(12, 768, 768): 4, (12, 768, 3072): 1, (12, 3072, 768): 1}
# gpt2-paper per forward: K1 for q/k/v/o, fc and proj in each layer
GPT2_K1_PER_LAYER = 6
# phase 8's model axis: ranks that share the one card
MESH_RANKS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def host_cpu() -> str:
    """The host's architecture and CPU model, as far as ``/proc/cpuinfo``
    names it (x86 gives a ``model name``, Arm only a ``CPU part`` code)."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, value = ln.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = fields.get("model name") or f"CPU part {fields.get('CPU part', 'unknown')}"
    return f"{platform.machine()} {model}"


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def f32_ceiling(nbytes: float, flops: float) -> str:
    """For K1's prefill (more than 8 rows): the least time of a design that
    keeps the first version's order of summation, which leaves the tensor
    cores out (f32 FMAs at the f32 peak), beside its bound."""
    ms, by = bound_ms(nbytes, flops, F32_FLOPS)
    return f"; an order-keeping f32 design's bound {ms:.4f} ms ({by})"


def time_ms(torch, fn, reps: int = 50) -> float:
    """Median device time of one call, by CUDA events, L2 flushed before
    each call (on the serving path the 205 MB a decode step streams do not
    fit the 50 MB L2).  A spin kernel ahead of the start event keeps the
    card busy while the host enqueues the call, so the host's launch
    latency stays outside the timed window."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def check_close(name: str, y, ref, rtol=BF16_RTOL) -> float:
    err = (y.float() - ref.float()).abs()
    bad = err > rtol * ref.float().abs() + ATOL
    why = ("2^-7*|ref|: one bf16 rounding step of an f32 result" if rtol == BF16_RTOL
           else f"{rtol}*|ref|: f32 sums in another order")
    log(f"  {name}: max_abs_err {err.max().item():.3e}  (tolerance {why}, + {ATOL})")
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond tolerance")
    return err.max().item()


def same_bytes(torch, name: str, y, again) -> None:
    """Two calls of one kernel on the same inputs must give the same bytes
    (its sums run in a fixed order: no atomics)."""
    if not torch.equal(y.view(torch.uint8), again.view(torch.uint8)):
        raise AssertionError(f"{name}: two calls gave different bytes")


def check_nm_spmm(torch, comp: dict, dev) -> dict:
    """K1 at the six matmuls of one gpt2-paper layer (q/k/v/o 768->768,
    fc 768->3072, proj 3072->768), in decode (B = 1, 4, 8) and prefill
    (B = 4 x 64 rows), each call twice (the same bytes; the prefill's rows
    0-3 also the bytes of a decode call of those rows alone); then at
    RecurrentGemma-9B's MLP widths (4096->12288, 12288->4096, B = 4) with
    its rate.  The record is one layer's six decode calls at B=4."""
    from repro_torch.kernels.nm_spmm import nm_spmm, nm_spmm_plain

    layer = comp["body"]["sb_0"]
    leaves = {k: layer["attn"][k].layer(0) for k in ("wq", "wk", "wv", "wo")}
    leaves.update({k: layer["mlp"][k].layer(0) for k in ("w_fc", "w_proj")})
    gen = torch.Generator(device=dev).manual_seed(1)
    rec = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for b in (1, 4, 8, 256):
        for name, w in leaves.items():
            k_dim = w.values.shape[0] * w.m // w.n
            x = torch.randn((b, k_dim), generator=gen, device=dev).to(torch.bfloat16)
            args = (x, w.values, w.indices, w.n, w.m, w.out_features)
            label = f"nm_spmm {name} B={b} ({k_dim}->{w.out_features})"
            y = nm_spmm(*args)
            same_bytes(torch, label, y, nm_spmm(*args))
            if b == 256:  # the prefill body gives rows 0-3 the decode kernel's bytes
                same_bytes(torch, f"{label} rows 0-3 alone", y[:4],
                           nm_spmm(x[:4].contiguous(), *args[1:]))
            err = check_close(label, y, nm_spmm_plain(*args))
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            # time every decode call at B=4, and prefill once per distinct shape
            if not (b == 4 or (b == 256 and name in ("wq", "w_fc", "w_proj"))):
                continue
            dense = w.dense().contiguous()
            t = dict(ms=time_ms(torch, lambda: nm_spmm(*args)),
                     plain_ms=time_ms(torch, lambda: nm_spmm_plain(*args)),
                     library_ms=time_ms(torch, lambda: torch.matmul(x, dense)))
            nbytes = (x.numel() * 2 + w.values.numel() * 2 + w.indices.numel()
                      + b * w.out_features * 2)
            flops = 2.0 * b * w.values.shape[0] * w.out_features
            t["bound_ms"], by = bound_ms(nbytes, flops)
            log(f"  time nm_spmm {name} B={b}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, torch.matmul(dense) {t['library_ms']:.4f} ms, "
                f"bound {t['bound_ms']:.4f} ms ({by})"
                f"{f32_ceiling(nbytes, flops) if b > 8 else ''}")
            if b == 4:
                for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                    rec[key] += t[key]
                rec["bound_by"] = by
    rec["at"] = "sum of one layer's six decode calls, x (4, K) bf16, 2:4"
    for k_dim, o in ((4096, 12288), (12288, 4096)):  # RecurrentGemma-9B's MLP, decode
        vals, idx = random_stack(torch, 1, k_dim, o, gen, dev)
        x = torch.randn((4, k_dim), generator=gen, device=dev).to(torch.bfloat16)
        args = (x, vals[0], idx[0], 2, 4)
        label = f"nm_spmm B=4 ({k_dim}->{o})"
        y = nm_spmm(*args)
        same_bytes(torch, label, y, nm_spmm(*args))
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 check_close(label, y, nm_spmm_plain(*args)))
        ms = time_ms(torch, lambda: nm_spmm(*args))
        nbytes = x.numel() * 2 + vals.numel() * 3 + 4 * o * 2
        log(f"  time nm_spmm B=4 {k_dim}->{o} (RecurrentGemma-9B MLP): kernel {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.0f} GB/s), bound "
            f"{bound_ms(nbytes, 2.0 * 4 * vals.numel())[0]:.4f} ms")
    return rec


def int8_pages(torch, pages: tuple, int8: bool) -> tuple:
    """``(pages, scales, views)``: with ``int8`` the pages as the port's
    int8 codes and their f16 ``(P, ps)`` scales (``models.cache.quant``),
    and the bf16 pages the codes stand for (what a one-call yardstick
    reads); else the pages as they are, no scales, and the pages again."""
    from repro_torch.models.cache import dequant, quant

    if not int8:
        return pages, (None,) * len(pages), pages
    coded = [quant(p, 2) for p in pages]
    return (tuple(c for c, _ in coded), tuple(sc for _, sc in coded),
            tuple(dequant(c, sc).to(torch.bfloat16) for c, sc in coded))


def row_bytes(width: int, itemsize: int, int8: bool) -> int:
    """Bytes of one stored row: ``width`` values, or int8 codes and an f16
    scale."""
    return width + 2 if int8 else width * itemsize


def _tables(torch, lengths, ps, n_slots, num_pages, gen):
    """Append-only tables: each lane's live pages at scattered ids, the rest
    sentinel."""
    perm = torch.randperm(num_pages, generator=gen).tolist()
    tables = torch.full((len(lengths), n_slots), num_pages, dtype=torch.int32)
    for i, ln in enumerate(lengths):
        for pg in range(-(-ln // ps)):
            tables[i, pg] = perm.pop()
    return tables


@dataclasses.dataclass
class AttnCase:
    """One ``paged_attn`` form's operands at its phase-2 shapes, with what
    its records need: ``pools`` names the operands that carry the pages
    axis (split by the K3 check), ``in_bytes`` the bytes every input is
    read once, ``out`` the output's elements, ``flops`` and ``peak`` the
    operations and the peak rate of their type, ``sdpa`` a one-call
    yardstick on the pre-gathered view."""

    name: str
    label: str
    at: str
    q: object
    pages: tuple  # (k_pages, v_pages or None)
    tables: object
    lens: object
    kw: dict
    dead: int
    rtol: float
    in_bytes: int
    out: int
    heads: int
    flops: float
    peak: float
    sdpa: object
    sdpa_label: str


def gqa_case(torch, dev, int8: bool) -> AttnCase:
    """K2's GQA form at B=4, H=12, D=64, ps=16: ragged lanes, sentinel
    slots, one dead lane; bf16 queries over bf16 pages (``int8``: the port's
    int8 codes and scales of the same pages)."""
    import torch.nn.functional as F

    b, h, d, ps, n_slots, num_pages = 4, 12, 64, 16, 7, 40
    lengths = [97, 33, 0, 70]
    gen = torch.Generator(device="cpu").manual_seed(2)
    tables = _tables(torch, lengths, ps, n_slots, num_pages, gen)
    q, kp, vp = (torch.randn(s, generator=gen).to(torch.bfloat16).to(dev) for s in (
        (b, h, 1, d), (num_pages, ps, h, d), (num_pages, ps, h, d)))
    (kp, vp), (ks, vs), (kv, vv) = int8_pages(torch, (kp, vp), int8)
    tables, lens = tables.to(dev), torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(scale=d ** -0.5, k_scale=ks, v_scale=vs)
    # yardstick: SDPA on the pre-gathered contiguous (B, H, S, D) view
    # (pre-dequantized to bf16 for int8 pages)
    phys = tables.long().clamp(max=num_pages - 1)
    kg = kv[phys].reshape(b, n_slots * ps, h, d).transpose(1, 2).contiguous()
    vg = vv[phys].reshape(b, n_slots * ps, h, d).transpose(1, 2).contiguous()
    mask = (torch.arange(n_slots * ps, device=dev)[None, :] < lens[:, None])[:, None, None]
    qs = q.reshape(b, h, 1, d)
    live = sum(lengths)
    return AttnCase(
        name="paged_attn" + ("_q" if int8 else ""), label="B=4 H=12 D=64 ps=16",
        at=f"q (4, 12, 1, 64) bf16, {'int8 pages + f16 scales' if int8 else 'bf16 pages'}, "
           f"ps=16, lengths {lengths}",
        q=q, pages=(kp, vp), tables=tables, lens=lens, kw=kw, dead=2, rtol=BF16_RTOL,
        in_bytes=(q.numel() * 2 + 2 * live * row_bytes(h * d, 2, int8) + tables.numel() * 4
                  + b * 4),
        out=b * h * d, heads=b * h, flops=4.0 * live * h * d, peak=BF16_FLOPS,
        sdpa=lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask,
                                                    scale=kw["scale"]),
        sdpa_label=f"SDPA on gathered {'bf16 ' if int8 else ''}view")


def win_tables(torch, lengths, ps, win, win_slots, num_pages, gen):
    """Modular window tables as the pool keeps them: each lane's live
    window pages and the page after its current one (mapped ahead of the
    write) at slot ``pg % win_slots``, scattered page ids; the rest
    sentinel."""
    perm = torch.randperm(num_pages, generator=gen).tolist()
    tables = torch.full((len(lengths), win_slots), num_pages, dtype=torch.int32)
    for i, ln in enumerate(lengths):
        if ln:
            for pg in range(max(0, ln - win) // ps, (ln - 1) // ps + 2):
                tables[i, pg % win_slots] = perm.pop()
    return tables


def win_case(torch, dev, int8: bool) -> AttnCase:
    """K2's window form (K2w) at RecurrentGemma-9B's decode: B = 4 lanes,
    one KV head of 256 under 16 query heads, ps = 16, window 2048 over the
    130-slot modular table the pool keeps at K = 4; lengths 2100 (slid past
    the window, a partial first page), 2048 (exactly the window), 1000
    (short of it) and 0 (dead); bf16 queries and pages (``int8``: the port's
    codes and scales of the same pages)."""
    import torch.nn.functional as F

    b, h, d, ps, win = 4, 16, 256, 16, 2048
    win_slots = -(-(win + 4 - 1) // ps) + 1
    lengths = [2100, 2048, 1000, 0]
    num_pages = b * win_slots
    gen = torch.Generator(device="cpu").manual_seed(6)
    tables = win_tables(torch, lengths, ps, win, win_slots, num_pages, gen).to(dev)
    q = torch.randn((b, 1, h, d), generator=gen).to(torch.bfloat16).to(dev)
    kp, vp = (torch.randn((num_pages, ps, 1, d), generator=gen).to(torch.bfloat16).to(dev)
              for _ in range(2))
    (kp, vp), (ks, vs), (kv, vv) = int8_pages(torch, (kp, vp), int8)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(scale=d ** -0.5, window=win, win_slots=win_slots, k_scale=ks, v_scale=vs)
    # yardstick: SDPA on the pre-gathered window, (B, H, win, D), MQA expanded
    # (pre-dequantized to bf16 for int8 pages)
    pos = torch.stack([torch.arange(win) + max(0, ln - win) for ln in lengths]).to(dev)
    phys = tables.long().gather(1, (pos // ps) % win_slots).clamp(max=num_pages - 1)
    kg = kv[phys, pos % ps].reshape(b, 1, win, d).expand(b, h, win, d).contiguous()
    vg = vv[phys, pos % ps].reshape(b, 1, win, d).expand(b, h, win, d).contiguous()
    mask = (torch.arange(win, device=dev)[None, :]
            < torch.tensor([min(ln, win) for ln in lengths], device=dev)[:, None])[:, None, None]
    qs = q.reshape(b, h, 1, d)
    live = sum(min(ln, win) for ln in lengths)
    return AttnCase(
        name="paged_attn_win" + ("_q" if int8 else ""),
        label="B=4 Hkv=1 G=16 D=256 ps=16 window 2048",
        at=f"q (4, 1, 16, 256) bf16, {'int8 pages + f16 scales' if int8 else 'bf16 pages'}, "
           f"ps=16, window 2048, 130 slots, lengths {lengths}",
        q=q, pages=(kp, vp), tables=tables, lens=lens, kw=kw, dead=3, rtol=BF16_RTOL,
        in_bytes=(q.numel() * 2 + 2 * live * row_bytes(d, 2, int8) + tables.numel() * 4
                  + b * 4),
        out=b * h * d, heads=b * h, flops=4.0 * live * h * d, peak=BF16_FLOPS,
        sdpa=lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask,
                                                    scale=kw["scale"]),
        sdpa_label=f"SDPA on the gathered {'bf16 ' if int8 else ''}window")


def mla_case(torch, dev, int8: bool) -> AttnCase:
    """K2's MLA form (K2m) at DeepSeek-V2-Lite's decode: B = 4, 16 heads,
    latent 512, RoPE 64, ps = 16, ragged lanes up to 96 tokens with a
    sentinel slot and a dead lane; f32 queries and output over bf16 pages
    (``int8``: the port's codes and scales of the same pages, held to an
    f32 tolerance since both sides compute and return f32)."""
    import torch.nn.functional as F

    b, h, lat, rd, ps, n_slots, num_pages = 4, 16, 512, 64, 16, 7, 40
    lengths = [96, 33, 0, 70]
    gen = torch.Generator(device="cpu").manual_seed(5)
    tables = _tables(torch, lengths, ps, n_slots, num_pages, gen)
    q, q2 = (torch.randn((b, 1, h, w), generator=gen).to(dev) for w in (lat, rd))
    cp, rp = (torch.randn((num_pages, ps, 1, w), generator=gen).to(torch.bfloat16).to(dev)
              for w in (lat, rd))
    (cp, rp), (cs, rs), (cv, rv) = int8_pages(torch, (cp, rp), int8)
    tables, lens = tables.to(dev), torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = (128 + rd) ** -0.5
    kw = dict(scale=scale, q2=q2, k2_pages=rp, v_is_k=True, k_scale=cs, k2_scale=rs)
    # yardstick: SDPA on the pre-gathered view, q = [q_lat|q2], k = [ckv|krope], v = ckv
    # (pre-dequantized to bf16 for int8 pages)
    phys = tables.long().clamp(max=num_pages - 1)
    s_all = n_slots * ps
    kcat = torch.cat([cv, rv], -1)[phys].reshape(b, 1, s_all, lat + rd).float()
    kg = kcat.expand(b, h, s_all, lat + rd).contiguous()
    vg = kcat[..., :lat].expand(b, h, s_all, lat).contiguous()
    qs = torch.cat([q, q2], -1).reshape(b, h, 1, lat + rd)
    mask = (torch.arange(s_all, device=dev)[None, :] < lens[:, None])[:, None, None]
    live = sum(lengths)
    return AttnCase(
        name="paged_attn_mla" + ("_q" if int8 else ""), label="B=4 H=16 latent 512 rope 64 ps=16",
        at=f"q (4, 1, 16, 512) + q2 (4, 1, 16, 64) f32, "
           f"{'int8 pages + f16 scales' if int8 else 'bf16 pages'}, ps=16, lengths {lengths}",
        q=q, pages=(cp, None), tables=tables, lens=lens, kw=kw, dead=2,
        rtol=F32_RTOL if int8 else BF16_RTOL,
        in_bytes=(q.numel() * 4 + q2.numel() * 4
                  + live * (row_bytes(lat, 2, int8) + row_bytes(rd, 2, int8))
                  + tables.numel() * 4 + b * 4),
        out=b * h * lat, heads=b * h, flops=2.0 * live * h * (lat + rd) + 2.0 * live * h * lat,
        peak=F32_FLOPS,  # the kernel's math is f32
        sdpa=lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask, scale=scale),
        sdpa_label="SDPA (f32) on gathered view")


ATTN_CASES = {"gqa": gqa_case, "window": win_case, "mla": mla_case}


def check_paged_attn(torch, dev, form: str, first_bytes: dict, int8: bool = False) -> dict:
    """K2 in one form (``int8``: K2q over the port's int8 codes and scales
    of the same pages) against its plain version at its phase-2 shapes,
    the dead lane exactly zero; then its time beside its bound, its plain
    version's and SDPA's on the pre-gathered view (for int8 pages a
    yardstick only: not the same function)."""
    from repro_torch.kernels.paged_attn import paged_attn, paged_attn_plain

    c = ATTN_CASES[form](torch, dev, int8)
    args = (c.q, *c.pages, c.tables, c.lens)
    y = paged_attn(*args, **c.kw)
    what = c.name.replace("_q", " int8")
    err = check_close(f"{what} {c.label}", y, paged_attn_plain(*args, **c.kw), rtol=c.rtol)
    if float(y[c.dead].abs().max()) != 0.0:
        raise AssertionError(f"{what}: the dead lane is not exactly zero")
    rec = dict(max_abs_err=err, ms=time_ms(torch, lambda: paged_attn(*args, **c.kw)),
               plain_ms=time_ms(torch, lambda: paged_attn_plain(*args, **c.kw)),
               library_ms=time_ms(torch, c.sdpa), at=c.at)
    rec["bound_ms"], rec["bound_by"] = bound_ms(c.in_bytes + c.out * c.q.element_size(),
                                                c.flops, c.peak)
    rec.update(second_call(torch, c.name, y, lambda: paged_attn(*args, **c.kw), first_bytes))
    if form != "window" and not int8:
        log(f"  time {what} at {'/'.join(map(str, LIVE_PAGES))} live pages a lane: "
            f"{live_page_times(torch, c)} ms")
    log(f"  time {what}: kernel {rec['ms']:.4f} ms{split_note(c.name, rec)}, plain "
        f"{rec['plain_ms']:.4f} ms, {c.sdpa_label} {rec['library_ms']:.4f} ms"
        f"{' (a yardstick only: not the same function)' if int8 else ''}, bound "
        f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    return rec


def live_page_times(torch, c: AttnCase) -> str:
    """The case's kernel with every lane at each of ``LIVE_PAGES`` live
    pages, each table slot on a page of its own: what a page costs beside
    the fixed cost of a call (log only)."""
    from repro_torch.kernels.paged_attn import paged_attn

    b, n_slots = c.tables.shape
    ps, dev = c.pages[0].shape[1], c.q.device
    tables = torch.arange(b * n_slots, dtype=torch.int32, device=dev).reshape(b, n_slots)
    times = []
    for pages in LIVE_PAGES:
        lens = torch.full((b,), pages * ps, dtype=torch.int32, device=dev)
        times.append(time_ms(torch, lambda: paged_attn(c.q, *c.pages, tables, lens, **c.kw)))
    return " / ".join(f"{t:.4f}" for t in times)


def second_call(torch, name: str, y, call, first_bytes: dict) -> dict:
    """A second call on the timed inputs must give the same bytes as the
    first (``y``, a tensor or the stats triple).  For the window form's
    entries also the blocks a lane of its split walk (``splits``), as the
    wrapper recorded it for that call; for the GQA and MLA forms the
    cases of their byte check against the first version's digests
    (``first_version_bytes``, from ``first_bytes``, what
    :func:`check_first_body_bytes` returned)."""
    from repro_torch.kernels import dispatch

    dispatch.last_splits.pop(name, None)
    again = call()
    torch.cuda.synchronize()
    pairs = zip(y, again) if isinstance(y, tuple) else [(y, again)]
    if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in pairs):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    if name in WINDOW_EARLIER_MS:
        log(f"  {name}: {dispatch.last_splits[name]} blocks a lane, two calls byte-identical")
        return {"splits": dispatch.last_splits[name]}
    cases = first_bytes[name]
    log(f"  {name}: two calls byte-identical; bytes equal to {FIRST_BODY} on {cases} cases")
    return {"first_version_bytes": f"equal to {FIRST_BODY} on {cases} cases"}


def split_note(name: str, rec: dict) -> str:
    if "splits" in rec:
        return (f" (S = {rec['splits']}; the one-block-per-lane walk took "
                f"{WINDOW_EARLIER_MS[name]} ms)")
    return f" (the first version's body took {BODY_EARLIER_MS[name]} ms)"


def check_first_body_bytes(torch, dev) -> dict:
    """The GQA and MLA body (K2, K2m, K2q, K3) against the first version's
    bytes: every case of ``kernels/paged_attn_check.py`` (both forms x f32
    and bf16 queries x f32, bf16 and int8 pages x both flushes, at phase
    2's shapes, the card tests' and edge shapes, and 256 grid shapes; dead
    lanes, sentinel slots and partial pages included) must hash to the digest the first version's kernel
    wrote.  Returns the cases each launch entry passed."""
    from repro_torch.kernels import paged_attn_check as check
    from repro_torch.kernels.paged_attn import paged_attn

    bad, cases = [], {}
    for key in check.keys():
        name = check.launch_entry(key)
        y = check.run(paged_attn, key, dev)
        if check.digest(y) != check.DIGESTS[key]:
            bad.append(key)
        cases[name] = cases.get(name, 0) + 1
    if bad:
        raise AssertionError(f"paged_attn's GQA/MLA body: {len(bad)} of {len(check.keys())} "
                             f"cases differ from {FIRST_BODY}'s bytes: {bad[:8]}")
    log(f"  paged_attn GQA/MLA body: all {len(check.keys())} cases byte-equal to {FIRST_BODY}'s "
        f"digests ({', '.join(f'{k} {v}' for k, v in cases.items())})")
    return cases


def _split(c: AttnCase, shard: int, shards: int) -> tuple:
    """Shard ``shard`` of ``shards`` page ranges of the case's pool: its
    pages, scale planes and second stream, and its table."""
    from repro_torch.kernels.sharded import shard_local_tables

    per = c.pages[0].shape[0] // shards

    def part(t):
        return None if t is None else t[shard * per:(shard + 1) * per]

    kw = {k: part(v) if k in ("k2_pages", "k_scale", "v_scale", "k2_scale") else v
          for k, v in c.kw.items()}
    local, _ = shard_local_tables(c.tables, shard, per)
    return (c.q, *(part(p) for p in c.pages), local.contiguous(), c.lens), kw


def check_paged_attn_stats(torch, dev, form: str, first_bytes: dict,
                           int8: bool = False) -> dict:
    """K3 (the stats form) in one form: ``(acc, m, l)`` against its plain
    version at K2's phase-2 shapes (``acc / l``, ``m`` and ``l`` each within
    1e-4·|ref| + 1e-5: f32 sums in another order), the dead lane exactly
    ``(0, -1e30, 0)``; then the one-card split check: the pool cut into S
    = 2 and 4 page ranges, K3 over each range with the table remapped to
    it (``shard_local_tables``), the triples combined
    (``combine_stats_local``) and cast, equal to K2 over the whole pool
    within K2's own tolerance, dead lanes exactly zero.  Timed beside its
    bound (K2's inputs, f32 ``acc``, ``m`` and ``l`` out) and its plain
    version; no one PyTorch call returns unnormalized flash stats, so
    ``library_ms`` is null and SDPA's time is kept as a yardstick."""
    from repro_torch.kernels.paged_attn import entry, paged_attn, paged_attn_stats_plain
    from repro_torch.kernels.sharded import combine_stats_local

    c = ATTN_CASES[form](torch, dev, int8)
    args = (c.q, *c.pages, c.tables, c.lens)
    name = entry(mla=form == "mla", window=form == "window", stats=True, quant=int8)
    acc, m, l = paged_attn(*args, emit_stats=True, **c.kw)
    racc, rm, rl = paged_attn_stats_plain(*args, **c.kw)
    err = 0.0
    for part, y, ref in (("acc / l", acc / l.clamp_min(1e-30)[..., None],
                          racc / rl.clamp_min(1e-30)[..., None]), ("m", m, rm), ("l", l, rl)):
        err = max(err, check_close(f"{name} {part} {c.label}", y, ref, rtol=F32_RTOL))
    err = max(err, float((acc - racc).abs().max()))
    dead = (float(acc[c.dead].abs().max()), set(m[c.dead].flatten().tolist()),
            float(l[c.dead].abs().max()))
    if dead != (0.0, {float(torch.tensor(-1e30, dtype=torch.float32))}, 0.0):
        raise AssertionError(f"{name}: the dead lane's stats are {dead}, not (0, -1e30, 0)")
    whole = paged_attn(*args, **c.kw)
    for shards in (2, 4):
        parts = [paged_attn(*a, emit_stats=True, **kw)
                 for a, kw in (_split(c, s, shards) for s in range(shards))]
        y = combine_stats_local(*(torch.stack(t) for t in zip(*parts))).to(c.q.dtype)
        check_close(f"{name} split into {shards} page ranges, combined, vs "
                    f"{c.name} on the whole pool", y, whole, rtol=c.rtol)
        if float(y[c.dead].abs().max()) != 0.0:
            raise AssertionError(f"{name} split {shards}: the dead lane is not exactly zero")
    rec = dict(max_abs_err=err,
               ms=time_ms(torch, lambda: paged_attn(*args, emit_stats=True, **c.kw)),
               plain_ms=time_ms(torch, lambda: paged_attn_stats_plain(*args, **c.kw)),
               library_ms=None, sdpa_yardstick_ms=time_ms(torch, c.sdpa), at=c.at)
    rec["bound_ms"], rec["bound_by"] = bound_ms(c.in_bytes + c.out * 4 + c.heads * 8,
                                                c.flops, c.peak)
    rec.update(second_call(torch, name, (acc, m, l),
                           lambda: paged_attn(*args, emit_stats=True, **c.kw), first_bytes))
    log(f"  time {name}: kernel {rec['ms']:.4f} ms{split_note(name, rec)}, plain "
        f"{rec['plain_ms']:.4f} ms, {c.sdpa_label} {rec['sdpa_yardstick_ms']:.4f} ms (a "
        f"yardstick only: not the same function), bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']})")
    return rec


def random_stack(torch, e, k, o, gen, dev):
    """Random 2:4-compressed ``(E, K/2, O)`` bf16 values and uint8 offsets
    (two distinct ascending offsets per group and column)."""
    idx = torch.rand((e, k // 4, 4, o), generator=gen, device=dev).argsort(dim=2)[:, :, :2]
    idx = idx.sort(dim=2).values.reshape(e, k // 2, o).to(torch.uint8).contiguous()
    vals = torch.randn((e, k // 2, o), generator=gen, device=dev).to(torch.bfloat16)
    return vals, idx


def check_nm_spmm_batched(torch, dev) -> dict:
    """The batched K1 at DeepSeek-V2-Lite's expert stacks: 64 experts of
    2048->1408 (gate, up) and 1408->2048 (down), 2:4, bf16, with C = 8 rows
    per expert (decode) and C = 32 (a 256-token prefill).  The record is one
    MoE layer's three decode launches.  Each call runs twice: the same
    bytes; C = 32's rows 0-7 also give a C = 8 call's bytes."""
    from repro_torch.kernels.nm_spmm import nm_spmm_batched, nm_spmm_batched_plain

    gen = torch.Generator(device=dev).manual_seed(4)
    rec = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for k, o, count in ((2048, 1408, 2), (1408, 2048, 1)):
        vals, idx = random_stack(torch, 64, k, o, gen, dev)
        dense = torch.zeros((64, k // 4, 4, o), dtype=torch.bfloat16, device=dev)
        dense.scatter_(2, idx.long().reshape(64, k // 4, 2, o), vals.reshape(64, k // 4, 2, o))
        dense = dense.reshape(64, k, o)
        for c in (8, 32):
            x = torch.randn((64, c, k), generator=gen, device=dev).to(torch.bfloat16)
            args = (x, vals, idx, 2, 4)
            label = f"nm_spmm_batched E=64 C={c} ({k}->{o})"
            y = nm_spmm_batched(*args)
            same_bytes(torch, label, y, nm_spmm_batched(*args))
            if c == 32:  # the prefill body gives rows 0-7 the decode kernel's bytes
                same_bytes(torch, f"{label} rows 0-7 alone", y[:, :8],
                           nm_spmm_batched(x[:, :8].contiguous(), *args[1:]))
            err = check_close(label, y, nm_spmm_batched_plain(*args))
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            t = dict(ms=time_ms(torch, lambda: nm_spmm_batched(*args)),
                     plain_ms=time_ms(torch, lambda: nm_spmm_batched_plain(*args), reps=10),
                     library_ms=time_ms(torch, lambda: torch.bmm(x, dense)))
            nbytes = x.numel() * 2 + vals.numel() * 2 + idx.numel() + 64 * c * o * 2
            flops = 2.0 * 64 * c * (k // 2) * o
            t["bound_ms"], by = bound_ms(nbytes, flops)
            log(f"  time nm_spmm_batched E=64 C={c} {k}->{o}: kernel {t['ms']:.4f} ms "
                f"({nbytes / t['ms'] / 1e6:.0f} GB/s), plain {t['plain_ms']:.4f} ms, "
                f"torch.bmm(dense) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({by})"
                f"{f32_ceiling(nbytes, flops) if c > 8 else ''}")
            if c == 8:
                for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                    rec[key] += count * t[key]
                rec["bound_by"] = by
        del dense
    rec["at"] = ("one MoE layer's three decode launches: x (64, 8, K) bf16, "
                 "2 x (64, 1024, 1408) + (64, 704, 2048), 2:4")
    return rec


def check_nm_mask(torch, dev) -> dict:
    """K4 bit-exact against its plain version: gpt2-paper's three stacked
    leaf shapes in bf16 and f32 at 2:4, other patterns at (768, 768), and a
    tie case; each result has exactly n ones per group.  The record is one
    mask pass over gpt2-paper's six maskable leaves in bf16."""
    from repro_torch.kernels.nm_mask import nm_mask, nm_mask_plain

    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [(shape, dt, 2, 4) for shape in MASK_LEAVES for dt in (torch.bfloat16, torch.float32)]
    cases += [((768, 768), torch.bfloat16, n, m) for n, m in ((1, 4), (2, 8), (4, 16))]
    ties = torch.tensor([-2.0, -1.0, 0.0, 1.0, 2.0], device=dev)[
        torch.randint(0, 5, (768, 768), generator=gen, device=dev)]
    ties[:64] = 0.0  # all-zero groups: the lowest rows win
    worst = 0.0
    for shape, dt, n, m in cases + [("ties", torch.bfloat16, 2, 4), ("ties", torch.float32, 1, 4)]:
        w = (ties if shape == "ties" else torch.randn(shape, generator=gen, device=dev)).to(dt)
        masked, mask = nm_mask(w, n, m)
        pmasked, pmask = nm_mask_plain(w, n, m)
        torch.cuda.synchronize()
        same = (torch.equal(mask.float().view(torch.int32), pmask.float().view(torch.int32))
                and torch.equal(masked.float().view(torch.int32), pmasked.float().view(torch.int32)))
        groups = mask.float().reshape(*mask.shape[:-2], mask.shape[-2] // m, m, mask.shape[-1])
        exact_n = bool((groups.sum(-2) == n).all())
        err = (masked.float() - pmasked.float()).abs().max().item()
        worst = max(worst, err)
        log(f"  nm_mask {tuple(w.shape)} {str(dt)[6:]} {n}:{m}{' ties' if shape == 'ties' else ''}: "
            f"bit-exact {same}, {n} per group {exact_n}, max_abs_err {err}")
        if not (same and exact_n):
            raise AssertionError(f"nm_mask {shape} {dt} {n}:{m} disagrees with its plain version")
    rec = dict(max_abs_err=worst, ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by="bytes",
               library_ms=None)
    for shape, count in MASK_LEAVES.items():
        w = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        t = dict(ms=time_ms(torch, lambda: nm_mask(w, 2, 4)),
                 plain_ms=time_ms(torch, lambda: nm_mask_plain(w, 2, 4)))
        t["bound_ms"], by = bound_ms(3 * w.numel() * 2, 0.0)  # read w, write Π⊙w and Π
        log(f"  time nm_mask {shape} bf16 2:4: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({by}); no one-call "
            f"PyTorch equivalent")
        for key in ("ms", "plain_ms", "bound_ms"):
            rec[key] += count * t[key]
    rec["at"] = ("one mask pass: 4 x (12,768,768) + (12,768,3072) + (12,3072,768) bf16, 2:4")
    return rec


def serve(torch, cfg, comp, dev, *, paged: bool, n_requests=8, lanes=4, prompt_len=64,
          gen=32, k=4, num_pages=22, prompts=None, max_len=None, kv_quant=False):
    """One greedy serving run of the port's engine (``kv_quant``: on int8
    pages); returns (engine, prompts, streams, seconds)."""
    import numpy as np

    from repro_torch.serving import DecodeEngine, SamplingParams

    max_len = max_len or prompt_len + gen + 1
    eng = DecodeEngine(cfg, comp, max_batch=lanes, max_len=max_len, seed=0,
                       num_pages=num_pages if paged else None, page_size=16,
                       steps_per_dispatch=k, kv_quant=kv_quant, device=dev)
    if prompts is None:
        prompts = [np.random.default_rng(1000 + r).integers(0, cfg.vocab, prompt_len).tolist()
                   for r in range(n_requests)]
    uids = [eng.submit(p, SamplingParams(max_new_tokens=gen)) for p in prompts]
    t0 = time.perf_counter()
    res = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for u in uids:
        if len(res[u].tokens) != gen or res[u].finish_reason != "length":
            raise AssertionError(f"request {u}: {len(res[u].tokens)} tokens, "
                                 f"{res[u].finish_reason}")
    return eng, prompts, [res[u].tokens for u in uids], wall


def compare_streams(torch, cfg, comp, prompts, a, b, dev,
                    margin=MARGIN) -> tuple[int, int, list]:
    """(equal tokens before the first difference, tokens, margins at the
    differences); raises if a difference is not a near-tie."""
    from repro_torch.models.model import forward

    agree, total, margins = 0, 0, []
    for p, x, y in zip(prompts, a, b):
        total += len(x)
        j = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v), len(x))
        agree += j
        if j == len(x):
            continue
        logits, _ = forward(comp, cfg, torch.tensor([p + x[:j]], device=dev))
        top2 = torch.topk(logits[0, -1].float(), 2).values
        margins.append(float(top2[0] - top2[1]))
        if margins[-1] >= margin:
            raise AssertionError(f"slab and paged streams differ at token {j} with "
                                 f"top-2 margin {margins[-1]:.4f} >= {margin}")
    return agree, total, margins


def serve_phase(torch, cfg, comp, dev, dispatch) -> tuple[dict, dict]:
    """Phase 3; returns the launches and, for phase 8, the prompts and the
    fp and int8 pools' pages, greedy streams and preemptions."""
    serve(torch, cfg, comp, dev, paged=True, n_requests=1, gen=4)  # warm-up, uncounted
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    slab, prompts, s_streams, s_wall = serve(torch, cfg, comp, dev, paged=False)
    after_slab = dict(dispatch.launches)
    paged, _, p_streams, p_wall = serve(torch, cfg, comp, dev, paged=True)
    launches = dict(dispatch.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches: slab {after_slab}, slab+paged {launches}")
    if after_slab["nm_spmm"] == 0 or launches["nm_spmm"] == after_slab["nm_spmm"]:
        raise AssertionError("nm_spmm kernel did not run on both serving runs")
    if launches["paged_attn"] == 0:
        raise AssertionError("paged_attn kernel did not run on the paged serving run")
    if paged.preemptions == 0:
        raise AssertionError("the undersized pool did not preempt")
    agree, total, margins = compare_streams(torch, cfg, comp, prompts, s_streams,
                                            p_streams, dev)
    log(f"  slab vs paged greedy streams: {agree}/{total} tokens equal before each "
        f"request's first difference; top-2 margins at the differences {margins} "
        f"(all < {MARGIN})")
    # int8 pages in the fp pool's device bytes: each page of each layer
    # holds K and V codes plus one f16 scale per slot for each
    fp_bytes = paged.kv_cache_bytes()
    q_page = cfg.n_layers * 16 * 2 * (cfg.n_kv * cfg.hd + 2)
    q_pages = fp_bytes // q_page - 1  # the sink page
    dispatch.reset_launches()
    quant, _, q_streams, q_wall = serve(torch, cfg, comp, dev, paged=True, num_pages=q_pages,
                                        kv_quant=True)
    q_launches = dict(dispatch.launches)
    log(f"  int8 pool of {q_pages} pages: {quant.kv_cache_bytes():,} B against the fp pool's "
        f"{fp_bytes:,} B ({paged.layout.num_pages} pages); launches {q_launches}")
    want = {"paged_attn_q": cfg.n_layers * quant.decode_steps, "paged_attn": 0}
    if any(q_launches[k] != v for k, v in want.items()) or q_launches["nm_spmm"] == 0:
        raise AssertionError(f"int8 run: launches {q_launches}, want {want} and nm_spmm > 0")
    if quant.kv_cache_bytes() > fp_bytes or not quant.preemptions < paged.preemptions:
        raise AssertionError(f"int8 pool: {quant.kv_cache_bytes()} B, {quant.preemptions} "
                             f"preemptions, against {fp_bytes} B, {paged.preemptions}")
    launches["paged_attn_q"] = q_launches["paged_attn_q"]
    log("  int8 vs fp pages (readings): " + json.dumps({
        **int8_readings(p_streams, q_streams),
        "one_step": route_difference(torch, cfg, comp, prompts[:4], dev)}))
    name = torch.cuda.get_device_name(0)
    for eng, wall in ((slab, s_wall), (paged, p_wall), (quant, q_wall)):
        st = eng.stats()
        log("  serve " + json.dumps({
            "layout": st["layout"], "kv_quant": st.get("kv_quant", False),
            "tokens_per_s": st["tokens_per_s"],
            "ms_per_decode_step": st["ms_per_decode_step"],
            "ms_per_decode_step_host": st["ms_per_decode_step_host"],
            "decode_steps": st["decode_steps"], "prefill_batches": st["prefill_batches"],
            "preemptions": st["preemptions"],
            "max_concurrency": st["max_concurrency"], "run_wall_s": wall,
            "kv_cache_bytes": st["kv_cache_bytes"],
            "weight_bytes_per_step": st["weight_bytes_per_step"],
            "weight_stream_bound_ms": st["weight_bytes_per_step"] / HBM_BYTES_PER_S * 1e3,
            "peak_memory_bytes": peak, "device": name,
        }))
    for kv_quant in (False, True):  # 4 lanes of 64 + 32 tokens: 28 pages, no preemption
        log(f"  profile gpt2 {'int8 ' if kv_quant else ''}paged decode "
            + json.dumps(profile_decode(torch, cfg, comp, dev, kv_quant=kv_quant)))
    single = {"prompts": prompts,
              "fp": dict(pages=paged.layout.num_pages, streams=p_streams,
                         preemptions=paged.preemptions),
              "int8": dict(pages=q_pages, streams=q_streams, preemptions=quant.preemptions)}
    return launches, single


def mesh_phase(torch, cfg, comp, dev, single: dict) -> dict:
    """Phase 8: full-width gpt2-paper served tensor-parallel by MESH_RANKS
    ranks on the one card (``launch.mesh.run_ranks``: gloo, since the ranks
    share it), phase 3's traffic on its fp and int8 pools.  Each rank keeps
    half the compressed weights and half the pool plus a sink page; its
    decode attention is K3 over its page range and the combine.  Gates:
    every request finishes its 32 tokens; streams, host page tables and one
    forward's logits are identical on every rank; streams equal phase 3's
    single-rank runs except at near-ties (top-2 margin under MARGIN); the
    same preemptions; per rank, K3's form of the pool (``paged_attn_stats``
    or ``_stats_q``) launches once a layer and decode step (12) and no other
    attention kernel launches, K1 six times a layer (72) a decode step and a
    prefill batch; 2 + 8 x 12 collectives a decode step.  Returns each K3
    form's launches summed over both pools' runs and the ranks."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.serve import serve_rank

    prompts = single["prompts"]
    engine_kw = dict(max_batch=4, max_len=64 + 32 + 1, seed=0, page_size=16,
                     steps_per_dispatch=4)
    runs = [dict(num_pages=single["fp"]["pages"], prompts=prompts[:1],
                 sampling=dict(max_new_tokens=4)),  # warm-up, uncounted
            dict(num_pages=single["fp"]["pages"]),
            dict(num_pages=single["int8"]["pages"], kv_quant=True)]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(serve_rank, (cfg, runs, prompts, dict(max_new_tokens=32), engine_kw),
                      model=MESH_RANKS, device=dev.type, tree=comp, log=lambda m: log("  " + m))
    log(f"  {MESH_RANKS} ranks started, served three runs and stopped in "
        f"{time.perf_counter() - t0:.1f} s")
    totals = {name: sum(r[i]["launches"][name] for r in ranks for i in (1, 2))
              for name in K3_FORMS}
    for i, pool in ((1, "fp"), (2, "int8")):
        recs = [r[i] for r in ranks]
        streams = [[rec["results"][u].tokens for u in sorted(rec["results"])] for rec in recs]
        for rec, st in zip(recs, streams):
            bad = [(u, r.finish_reason, len(r.tokens)) for u, r in rec["results"].items()
                   if r.finish_reason != "length" or len(r.tokens) != 32]
            if len(st) != len(prompts) or bad:
                raise AssertionError(f"{pool}: unfinished requests {bad}")
        for key in ("tables_digest", "logits_digest"):
            if len({rec[key] for rec in recs}) != 1 or any(s != streams[0] for s in streams):
                raise AssertionError(f"{pool}: the ranks disagree on their streams or {key}")
        k3 = "paged_attn_stats_q" if pool == "int8" else "paged_attn_stats"
        for r, rec in enumerate(recs):
            st, n = rec["stats"], rec["launches"]
            steps, groups = st["decode_steps"], st["prefill_batches"]
            want = {name: 0 for name in n if name.startswith("paged_attn")}
            want.update({k3: cfg.n_layers * steps,
                         "nm_spmm": GPT2_K1_PER_LAYER * cfg.n_layers * (steps + groups)})
            got = {name: n[name] for name in want}
            if got != want:
                raise AssertionError(f"{pool} rank {r}: launches {got}, want {want}")
            if st["collectives_per_decode_step"] != 2 + 8 * cfg.n_layers:
                raise AssertionError(f"{pool} rank {r}: {st['collectives_per_decode_step']} "
                                     "collectives a decode step")
        st = recs[0]["stats"]
        if st["preemptions"] != single[pool]["preemptions"]:
            raise AssertionError(f"{pool}: {st['preemptions']} preemptions against phase 3's "
                                 f"{single[pool]['preemptions']}")
        agree, total, margins = compare_streams(torch, cfg, comp, prompts,
                                                single[pool]["streams"], streams[0], dev)
        log(f"  {pool} pool of {single[pool]['pages']} pages on {MESH_RANKS} ranks: launches "
            f"per rank {recs[0]['launches']}; single-rank vs mesh greedy streams: "
            f"{agree}/{total} tokens equal before each request's first difference, top-2 "
            f"margins at the differences {margins} (all < {MARGIN})")
        log("  serve mesh " + json.dumps({
            "pool": pool, "num_pages": single[pool]["pages"], "mesh": st["mesh"],
            "tokens_per_s": st["tokens_per_s"], "ms_per_decode_step": st["ms_per_decode_step"],
            "ms_per_decode_step_host": st["ms_per_decode_step_host"],
            "decode_steps": st["decode_steps"], "preemptions": st["preemptions"],
            "collectives_per_decode_step": st["collectives_per_decode_step"],
            "collective_ms_per_decode_step": st["collective_ms_per_decode_step"],
            "kernel_route": recs[0]["kernel_route"], "run_wall_s": recs[0]["wall_s"],
            "per_rank_weight_bytes": [rec["stats"]["weight_bytes_per_step"] for rec in recs],
            "per_rank_kv_cache_bytes": [rec["stats"]["kv_cache_bytes"] for rec in recs],
            "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}))
    return totals


def deepseek_phase(torch, dev, dispatch) -> dict:
    """Phase 6: full-width DeepSeek-V2-Lite, exported and compressed leaf by
    leaf, served on the slab, a pool that never preempts and one that does;
    returns the launches of the batched nm_spmm and of paged_attn's MLA
    form over the three runs."""
    from repro_torch import core
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.sparse_infer import export_compressed

    cfg = get_config("deepseek-v2-lite-16b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n_params = sum(p.numel() for p in _leaves(params))
    recipe = core.make_recipe("step", core.SparsityConfig(default=core.NMSparsity(2, 4)))
    comp, rep = export_compressed(params, recipe)
    del params
    torch.cuda.synchronize()
    log(f"  {cfg.n_layers} layers, {n_params:,} parameters: init {t1 - t0:.1f} s, "
        f"export + compress leaf by leaf {time.perf_counter() - t1:.1f} s, {json.dumps(rep)}; "
        f"peak memory {torch.cuda.max_memory_allocated():,} B, compressed tree "
        f"{torch.cuda.memory_allocated():,} B")
    serve(torch, cfg, comp, dev, paged=True, n_requests=1, gen=4, num_pages=28)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    totals = {"nm_spmm_batched": 0, "paged_attn_mla": 0, "paged_attn_mla_q": 0}
    runs = {}
    for name, pages in (("slab", None), ("paged", 28), ("paged_preempting", 22),
                        ("paged_int8", 28)):
        int8 = name == "paged_int8"
        dispatch.reset_launches()
        eng, prompts, streams, wall = serve(torch, cfg, comp, dev, paged=pages is not None,
                                            num_pages=pages or 0, kv_quant=int8)
        launches = dict(dispatch.launches)
        steps, groups = eng.decode_steps, eng.prefill_batches
        mla = "paged_attn_mla_q" if int8 else "paged_attn_mla"
        want = {"nm_spmm_batched": 3 * DS_MOE_LAYERS * (steps + groups),
                "paged_attn_mla": DS_LAYERS * steps if pages and not int8 else 0,
                "paged_attn_mla_q": DS_LAYERS * steps if int8 else 0}
        log(f"  {name}: launches {launches}; {steps} decode steps, {groups} prefill batches: "
            f"batched nm_spmm wants 3 x {DS_MOE_LAYERS} x ({steps} + {groups}) = "
            f"{want['nm_spmm_batched']}, {mla} {DS_LAYERS} x {steps if pages else 0}")
        if any(launches[k] != v for k, v in want.items()) or launches["nm_spmm"] == 0:
            raise AssertionError(f"{name}: launches {launches}, want {want} and nm_spmm > 0")
        if (eng.preemptions > 0) != (name == "paged_preempting"):
            raise AssertionError(f"{name}: {eng.preemptions} preemptions")
        for k in totals:
            totals[k] += launches[k]
        runs[name] = (eng, streams, wall)
    log("  int8 vs fp pages, 28-page pools (readings): "
        + json.dumps(int8_readings(runs["paged"][1], runs["paged_int8"][1])))
    # the two decode routes from one state: f32 on the first 4 layers must
    # agree to summation order; bf16 shows the rounding the streams see
    routes = {}
    for dtype, n_body in (("float32", 3), ("bfloat16", 3), ("bfloat16", DS_MOE_LAYERS)):
        sub_cfg, sub = first_layers(torch, cfg, comp, n_body, dtype)
        routes[f"{dtype} {1 + n_body} layers"] = route_difference(torch, sub_cfg, sub,
                                                                  prompts[:4], dev)
        del sub
    log("  one decode step after one prefill, slab (expanded) vs paged (absorbed, K2m): "
        + json.dumps(routes))
    if routes["float32 4 layers"]["max_abs_diff"] > DS_ROUTE_F32_TOL:
        raise AssertionError(f"the slab and paged decode routes differ by more than "
                             f"{DS_ROUTE_F32_TOL} in f32: {routes['float32 4 layers']}")
    agree, total, margins = compare_streams(torch, cfg, comp, prompts, runs["slab"][1],
                                            runs["paged"][1], dev, margin=DS_MARGIN)
    log(f"  slab vs non-preempting paged greedy streams: {agree}/{total} tokens equal before "
        f"each request's first difference; top-2 margins at the differences {margins} "
        f"(all < {DS_MARGIN})")
    peak = torch.cuda.max_memory_allocated()
    for name, (eng, _, wall) in runs.items():
        st = eng.stats()
        log("  serve deepseek " + json.dumps({
            "run": name, "tokens_per_s": st["tokens_per_s"],
            "ms_per_decode_step": st["ms_per_decode_step"],
            "ms_per_decode_step_host": st["ms_per_decode_step_host"],
            "decode_steps": st["decode_steps"], "prefill_batches": st["prefill_batches"],
            "preemptions": st["preemptions"], "run_wall_s": wall,
            "kv_cache_bytes": st["kv_cache_bytes"],
            "weight_bytes_per_step": st["weight_bytes_per_step"],
            "weight_stream_bound_ms": st["weight_bytes_per_step"] / HBM_BYTES_PER_S * 1e3,
            "peak_memory_bytes": peak, "device": torch.cuda.get_device_name(0),
        }))
    for quant in (False, True):
        log(f"  profile deepseek {'int8 ' if quant else ''}paged decode "
            + json.dumps(profile_decode(torch, cfg, comp, dev, kv_quant=quant)))
    return totals


def first_layers(torch, cfg, comp, n_body: int, dtype: str):
    """``(cfg, tree)``: the unstacked ``head_*`` and ``tail_*`` layers and
    the first ``n_body`` periods of the stacked layers of the compressed
    tree at full width, every float leaf in ``dtype`` (views where nothing
    changes)."""
    from repro_torch.models.model import layer_plan
    from repro_torch.sparse_infer import CompressedTensor
    from repro_torch.utils.tree import tree_map_with_name

    dt = getattr(torch, dtype)

    def leaf(name, x):
        n = n_body if name.startswith("body/") else None
        if isinstance(x, CompressedTensor):
            return dataclasses.replace(
                x, values=x.values[:n].to(dt), indices=x.indices[:n],
                shape=x.shape if n is None else (n,) + tuple(x.shape[1:]))
        return x[:n].to(dt) if x.is_floating_point() else x[:n]

    plan = layer_plan(cfg)
    n_layers = len(plan.head) + n_body * len(plan.period) + len(plan.tail)
    return (dataclasses.replace(cfg, n_layers=n_layers, param_dtype=dtype),
            tree_map_with_name(leaf, comp))


def route_difference(torch, cfg, comp, prompts, dev) -> dict:
    """The decode routes from one state: the prompts prefilled once,
    written into a slab, an fp paged cache and an int8 paged cache, then
    one decode step of the same tokens through each; the largest logit
    difference slab vs fp pages (and int8 vs fp pages, a reading), beside
    the logits' spread and the lanes' top-2 margins."""
    from repro_torch.models.cache import PagedLayout
    from repro_torch.models.model import decode_step, forward, init_cache, write_prefill

    b, s = len(prompts), len(prompts[0])
    toks = torch.tensor(prompts, device=dev)
    logits, produced = forward(comp, cfg, toks, want_cache=True)
    lanes = torch.arange(b, device=dev)
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    nxt = logits[:, -1].argmax(-1)
    slab = init_cache(cfg, b, s + 1, device=dev)
    write_prefill(slab, cfg, produced, lanes, lens)
    ls = decode_step(comp, cfg, nxt, slab)[0].float()
    del slab
    lp = {}
    for quant in (False, True):
        layout = PagedLayout(page_size=16, num_pages=b * -(-(s + 1) // 16), max_len=s + 1,
                             quant=quant)
        paged = init_cache(cfg, b, s + 1, layout=layout, device=dev)
        paged["tables"]["full"].copy_(
            torch.arange(layout.num_pages, dtype=torch.int32).reshape(b, -1))
        write_prefill(paged, cfg, produced, lanes, lens, layout)
        lp[quant] = decode_step(comp, cfg, nxt, paged, layout)[0].float()
        del paged
    top2 = torch.topk(ls, 2).values
    return {"max_abs_diff": (ls - lp[False]).abs().max().item(), "logit_std": ls.std().item(),
            "top2_margins": (top2[:, 0] - top2[:, 1]).tolist(),
            "same_argmax": (ls.argmax(-1) == lp[False].argmax(-1)).tolist(),
            "int8_vs_fp_pages_max_abs_diff": (lp[True] - lp[False]).abs().max().item(),
            "int8_vs_fp_pages_same_argmax": (lp[True].argmax(-1) == lp[False].argmax(-1)).tolist()}


def int8_readings(fp_streams: list, q_streams: list) -> dict:
    """An int8 run against the fp run of the same traffic, as readings (no
    gate): each request's first generated token (from prefill, which reads
    fresh fp K/V: it should be the fp run's), and how many greedy tokens
    agree before each request's first difference."""
    agree = sum(next((i for i, (u, v) in enumerate(zip(a, b)) if u != v), len(a))
                for a, b in zip(fp_streams, q_streams))
    return {"first_token_equal": [a[0] == b[0] for a, b in zip(fp_streams, q_streams)],
            "greedy_tokens_equal_before_first_difference":
                f"{agree}/{sum(len(a) for a in fp_streams)}"}


def profile_decode(torch, cfg, comp, dev, n_dispatch: int = 2, max_len=97, num_pages=28,
                   prompt_lens=(64, 64, 64, 64), kv_quant=False) -> dict:
    """A ``torch.profiler`` trace of ``n_dispatch`` decode dispatches (K = 4
    steps each) with 4 busy lanes on a pool (``kv_quant``: of int8 pages)
    that does not preempt: wall and device-busy ms per decode step, the
    idle share, kernels per step, the device ms a step of each of
    ``paged_attn``'s and ``nm_spmm``'s CUDA kernels and the eight kernels
    with the most device time."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import DecodeEngine, SamplingParams

    eng = DecodeEngine(cfg, comp, max_batch=4, max_len=max_len, seed=0, num_pages=num_pages,
                       page_size=16, steps_per_dispatch=4, kv_quant=kv_quant, device=dev)
    for r, n in enumerate(prompt_lens):
        eng.submit(np.random.default_rng(2000 + r).integers(0, cfg.vocab, n).tolist(),
                   SamplingParams(max_new_tokens=32))
    eng.step()  # admission and the first dispatch, untraced
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_dispatch):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = n_dispatch * eng.steps_per_dispatch
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # paged_attn's and nm_spmm's CUDA kernels by name (the window form's walk
    # and combine are paged_attn_win_kernel and paged_attn_win_combine; K1's
    # are nm_spmm_decode and, in prefill, nm_spmm_prefill)
    by_name = {"paged_attn": {}, "nm_spmm": {}}
    for e in kernels:
        found = re.search(r"((paged_attn|nm_spmm)\w*)<", e.key)
        if found:
            into = by_name[found[2]]
            into[found[1]] = into.get(found[1], 0.0) + e.self_device_time_total / 1e3 / n
    return {
        "ms_per_decode_step": wall_ms / n,
        "device_busy_ms_per_step": busy_ms / n if busy_ms > 0 else "not measured",
        "idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else "not measured",
        "kernels_per_step": sum(e.count for e in kernels) / n,
        **{f"{name}_device_ms_per_step": ms if busy_ms > 0 else "not measured"
           for name, ms in by_name.items()},
        "top_kernels_ms_per_step": {e.key[:70]: e.self_device_time_total / 1e3 / n for e in top},
    }


def window_route_difference(torch, cfg, comp, prompt_len: int, dev) -> dict:
    """The slab and paged decode routes of a windowed model from one state:
    4 prompts of ``prompt_len`` tokens (past the window) prefilled once,
    written into the rolling window slab and into a pool's modular window
    table, then one decode step of the same tokens through each (the
    slab's gathered attention, K2w on the pool); the largest logit
    difference beside the logits' spread."""
    import numpy as np

    from repro_torch.models.model import decode_step, forward, init_cache, write_prefill
    from repro_torch.serving.kv_pool import PagedKVPool

    b, max_len = 4, prompt_len + 2
    toks = torch.tensor(np.random.default_rng(3000).integers(0, cfg.vocab, (b, prompt_len)),
                        device=dev)
    with torch.no_grad():
        logits, produced = forward(comp, cfg, toks, want_cache=True)
    lanes = torch.arange(b, device=dev)
    lens = torch.full((b,), prompt_len, dtype=torch.int32, device=dev)
    pools = {}
    for quant in (False, True):  # fp pages, and int8 pages for a reading
        pool = PagedKVPool(cfg, max_batch=b, max_len=max_len, num_pages=b * 130, quant=quant,
                           device=dev)
        for i in range(b):
            pool.alloc_prefill(i, prompt_len)
            pool.ensure_steps(i, prompt_len, 1)
        pool.device_tables()
        write_prefill(pool.cache, cfg, produced, lanes, lens, pool.layout)
        pools[quant] = pool
    slab = init_cache(cfg, b, max_len, device=dev)
    write_prefill(slab, cfg, produced, lanes, lens)
    del produced
    nxt = logits[:, -1].argmax(-1)
    del logits
    ls = decode_step(comp, cfg, nxt, slab)[0].float()
    lp, lq = (decode_step(comp, cfg, nxt, p.cache, p.layout)[0].float()
              for p in (pools[False], pools[True]))
    return {"max_abs_diff": (ls - lp).abs().max().item(), "logit_std": ls.std().item(),
            "window_table": "win" in pools[False].cache["tables"],
            "same_argmax": (ls.argmax(-1) == lp.argmax(-1)).tolist(),
            "int8_vs_fp_pages_max_abs_diff": (lq - lp).abs().max().item(),
            "int8_vs_fp_pages_same_argmax": (lq.argmax(-1) == lp.argmax(-1)).tolist()}


def recurrentgemma_phase(torch, dev, dispatch) -> dict:
    """Phase 7: full-width RecurrentGemma-9B, exported and compressed leaf
    by leaf, served on the slab, a pool that never preempts and one that
    does; returns the launches of K1 and K2w over the three runs."""
    import numpy as np

    from repro_torch import core
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.sparse_infer import export_compressed

    cfg = get_config("recurrentgemma-9b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n_params = sum(p.numel() for p in _leaves(params))
    recipe = core.make_recipe("step", core.SparsityConfig(default=core.NMSparsity(2, 4)))
    comp, rep = export_compressed(params, recipe)
    del params
    torch.cuda.synchronize()
    log(f"  {cfg.n_layers} layers, {n_params:,} parameters: init {t1 - t0:.1f} s, "
        f"export + compress leaf by leaf {time.perf_counter() - t1:.1f} s, {json.dumps(rep)}; "
        f"peak memory {torch.cuda.max_memory_allocated():,} B, compressed tree "
        f"{torch.cuda.memory_allocated():,} B")
    prompts = [np.random.default_rng(4000 + r).integers(0, cfg.vocab, n).tolist()
               for r, n in enumerate(RG_PROMPTS)]
    run = dict(lanes=4, gen=RG_GEN, k=4, max_len=RG_MAX_LEN)
    serve(torch, cfg, comp, dev, paged=True, prompts=[prompts[3][:32]], gen=4,
          num_pages=RG_PAGES, max_len=RG_MAX_LEN)  # warm-up, uncounted
    torch.cuda.reset_peak_memory_stats()
    totals = {"nm_spmm": 0, "paged_attn_win": 0, "paged_attn_win_q": 0}
    runs = {}
    for name, pages in (("slab", None), ("paged", RG_PAGES),
                        ("paged_preempting", RG_PAGES_PREEMPTING), ("paged_int8", RG_PAGES)):
        int8 = name == "paged_int8"
        dispatch.reset_launches()
        eng, _, streams, wall = serve(torch, cfg, comp, dev, paged=pages is not None,
                                      num_pages=pages or 0, prompts=prompts, kv_quant=int8,
                                      **run)
        launches = dict(dispatch.launches)
        steps, groups = eng.decode_steps, eng.prefill_batches
        win = "paged_attn_win_q" if int8 else "paged_attn_win"
        want = {"nm_spmm": RG_K1_PER_PASS * (steps + groups),
                "paged_attn_win": RG_ATTN_LAYERS * steps if pages and not int8 else 0,
                "paged_attn_win_q": RG_ATTN_LAYERS * steps if int8 else 0,
                "paged_attn": 0, "paged_attn_mla": 0, "nm_spmm_batched": 0,
                "paged_attn_q": 0, "paged_attn_mla_q": 0}
        log(f"  {name}: launches {launches}; {steps} decode steps, {groups} prefill batches: "
            f"nm_spmm wants {RG_K1_PER_PASS} x ({steps} + {groups}) = {want['nm_spmm']}, "
            f"{win} {RG_ATTN_LAYERS} x {steps if pages else 0}")
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"{name}: launches {launches}, want {want}")
        if (eng.preemptions > 0) != (name == "paged_preempting"):
            raise AssertionError(f"{name}: {eng.preemptions} preemptions")
        if pages is not None:
            tables = sorted(eng.cache["tables"])
            log(f"  {name}: tables {tables}, {eng.pool.evicted_pages} window pages evicted, "
                f"{eng.preemptions} preemptions")
            if tables != ["win"] or eng.pool.evicted_pages == 0:
                raise AssertionError(f"{name}: tables {tables}, "
                                     f"{eng.pool.evicted_pages} evicted pages")
        if int8 and eng.pool.evicted_pages != runs["paged"][0].pool.evicted_pages:
            raise AssertionError(f"int8 run evicted {eng.pool.evicted_pages} pages, the fp "
                                 f"run {runs['paged'][0].pool.evicted_pages}")
        for k in totals:
            totals[k] += launches[k]
        runs[name] = (eng, streams, wall)
    log("  int8 vs fp pages, 520-page pools (readings): "
        + json.dumps(int8_readings(runs["paged"][1], runs["paged_int8"][1])))
    agree, total, margins = compare_streams(torch, cfg, comp, prompts, runs["slab"][1],
                                            runs["paged"][1], dev, margin=RG_MARGIN)
    log(f"  slab vs non-preempting paged greedy streams: {agree}/{total} tokens equal before "
        f"each request's first difference; top-2 margins at the differences {margins} "
        f"(all < {RG_MARGIN})")
    # the two decode routes from one state past the window: f32 on the
    # first period and the tail must agree to summation order; bf16 at
    # full depth shows the rounding the streams see
    routes = {}
    for dtype, n_body in (("float32", 1), ("bfloat16", 12)):
        sub_cfg, sub = (first_layers(torch, cfg, comp, n_body, dtype) if dtype != "bfloat16"
                        else (cfg, comp))
        routes[f"{dtype} {sub_cfg.n_layers} layers"] = window_route_difference(
            torch, sub_cfg, sub, RG_PROMPTS[0], dev)
        del sub
    log("  one decode step after one prefill, slab (rolled window) vs paged (K2w): "
        + json.dumps(routes))
    f32 = routes["float32 5 layers"]
    if f32["max_abs_diff"] > RG_ROUTE_F32_TOL or not f32["window_table"]:
        raise AssertionError(f"the slab and paged window routes differ by more than "
                             f"{RG_ROUTE_F32_TOL} in f32: {f32}")
    peak = torch.cuda.max_memory_allocated()
    for name, (eng, _, wall) in runs.items():
        st = eng.stats()
        log("  serve recurrentgemma " + json.dumps({
            "run": name, "tokens_per_s": st["tokens_per_s"],
            "ms_per_decode_step": st["ms_per_decode_step"],
            "ms_per_decode_step_host": st["ms_per_decode_step_host"],
            "decode_steps": st["decode_steps"], "prefill_batches": st["prefill_batches"],
            "preemptions": st["preemptions"], "evicted_pages": st.get("evicted_pages", 0),
            "run_wall_s": wall, "kv_cache_bytes": st["kv_cache_bytes"],
            "kv_bytes_per_step": st["kv_bytes_per_step"],
            "weight_bytes_per_step": st["weight_bytes_per_step"],
            "weight_stream_bound_ms": st["weight_bytes_per_step"] / HBM_BYTES_PER_S * 1e3,
            "peak_memory_bytes": peak, "device": torch.cuda.get_device_name(0),
        }))
    for quant in (False, True):
        log(f"  profile recurrentgemma {'int8 ' if quant else ''}paged decode "
            + json.dumps(profile_decode(torch, cfg, comp, dev, max_len=RG_MAX_LEN,
                                        num_pages=RG_PAGES, prompt_lens=RG_PROMPTS,
                                        kv_quant=quant)))
    return totals


def _leaves(tree):
    from repro_torch.utils.tree import tree_items

    return [leaf for _, leaf in tree_items(tree)]


def _median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2]


def train_phase(torch, dev, dispatch, ckpt_dir: str, argv=TRAIN_ARGS) -> dict:
    """Phase 4: STEP training through the launcher's Trainer; returns the
    nm_mask launches of the run and its export."""
    import numpy as np

    from repro_torch.launch import train as launch_train

    args = launch_train.parse_args(argv + ["--ckpt-dir", ckpt_dir])
    run = launch_train.build(args, dev)
    tr = run.trainer
    tr.cfg = dataclasses.replace(tr.cfg, log_every=1)  # every step's loss, synced
    asw = tr.step_cfg.autoswitch
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    try:
        state, hist = tr.run(run.params)
    finally:
        tr.data.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = launch_train.summarize(run, state, args, dev)  # the export: 6 launches
    launches = dict(dispatch.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in hist]
    bad = [m["step"] for m in hist if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]))]
    if bad or len(hist) != args.steps:
        raise AssertionError(f"non-finite loss or grad norm at steps {bad} ({len(hist)} logged)")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    log(f"  loss: first 10 steps {first:.4f}, last 10 {last:.4f}; per step "
        f"{[round(x, 3) for x in losses]}")
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    t_sw = state.opt.t0
    if not (state.opt.phase2 and asw.t_min < t_sw <= asw.t_max + 1):
        raise AssertionError(f"switch at t0={t_sw}, outside ({asw.t_min}, {asw.t_max + 1}]")
    masked_steps = sum(int(m["mask_active"]) for m in hist)
    want = 6 * masked_steps + 6
    log(f"  t0 {t_sw}, masked steps {masked_steps}, launches {launches} "
        f"(nm_mask wants 6 x {masked_steps} + 6 = {want})")
    if launches["nm_mask"] != want:
        raise AssertionError(f"nm_mask launched {launches['nm_mask']} times, want {want}")
    sparse = run.recipe.export_sparse(state.params)
    for name, p in _maskable(run.recipe, sparse):
        nz = (p != 0).reshape(p.shape[0], p.shape[1] // 4, 4, p.shape[2]).sum(2)
        if not bool((nz <= 2).all()):
            raise AssertionError(f"exported {name} is not 2:4")
    p1 = [m["step_time_s"] * 1e3 for m in hist[1:] if not m["phase2"]]  # step 0 warms up
    p2 = [m["step_time_s"] * 1e3 for m in hist if m["mask_active"]]
    tokens = args.batch * args.seq
    log("  train " + json.dumps({
        "steps": args.steps, "t0": t_sw, "masked_steps": masked_steps,
        "ms_per_step_phase1_median": _median(p1), "ms_per_step_phase2_median": _median(p2),
        "tokens_per_s_phase1": tokens / _median(p1) * 1e3,
        "tokens_per_s_phase2": tokens / _median(p2) * 1e3,
        "tokens_per_s_run": tokens * args.steps / wall, "run_wall_s": wall,
        "peak_memory_bytes": peak, "final_sparse_eval_loss": summary["final_sparse_eval_loss"],
        "device": torch.cuda.get_device_name(0),
    }))
    # where a step's time goes: 3 traced steps of each phase, phase 1 on a
    # fresh state, phase 2 on the trained one (the checkpoint is written)
    batches = [{k: torch.as_tensor(v).to(dev)
                for k, v in run.batch_fn(10**5 + i, args.batch).items()} for i in range(4)]
    for phase, st in (("phase1", tr.init_state(run.params)), ("phase2", state)):
        rec, st = profile_steps(torch, tr._step, st, batches)
        del st
        log(f"  profile {phase} " + json.dumps(rec))
    return launches


def profile_steps(torch, step_fn, state, batches) -> tuple[dict, object]:
    """A ``torch.profiler`` trace of ``step_fn`` over ``batches`` (after one
    untraced warm-up step): wall and device-busy ms per step, the idle
    share, kernels launched per step, and the six kernels with the most
    device time.  Returns the record and the advanced state."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, _ = step_fn(state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            state, _ = step_fn(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = len(batches) - 1
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "ms_per_step": wall_ms / n,
        "device_busy_ms_per_step": busy_ms / n if busy_ms > 0 else "not measured",
        "idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else "not measured",
        "kernels_per_step": sum(e.count for e in kernels) / n,
        "top_kernels_ms_per_step": {e.key[:70]: e.self_device_time_total / 1e3 / n for e in top},
    }, state


def _maskable(recipe, tree):
    from repro_torch.utils.tree import tree_items

    return [(n, p) for n, p in tree_items(tree)
            if recipe.sparsity.pattern_for(n, tuple(p.shape)) is not None]


def serve_trained_phase(torch, cfg, dev, dispatch, ckpt_dir: str) -> dict:
    """Phase 5: restore the trained params, export, compress, serve."""
    from repro_torch import core
    from repro_torch.checkpoint import restore_latest
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.sparse_infer import export_compressed

    params, _, step = restore_latest(ckpt_dir, prefix="params", device=dev)
    recipe = core.make_recipe("step", core.SparsityConfig(default=core.NMSparsity(2, 4)))
    comp, _ = export_compressed(params, recipe)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=16, seed=42, n_states=16)
    prompts = ds.batch(10**6, 4)["tokens"].tolist()  # held-out corpus prompts
    dispatch.reset_launches()
    _, _, streams, wall = serve(torch, cfg, comp, dev, paged=False, n_requests=4, lanes=4,
                                prompt_len=16, gen=8, prompts=prompts)
    launches = dict(dispatch.launches)
    in_alphabet = sum(t < 16 for s in streams for t in s) / sum(len(s) for s in streams)
    log(f"  restored step {step}; served 4 x 8 tokens in {wall:.3f} s, launches {launches}; "
        f"{in_alphabet:.3f} of generated tokens in the corpus's 16 symbols; streams {streams}")
    if launches["nm_spmm"] == 0:
        raise AssertionError("nm_spmm did not run serving the trained model")
    if in_alphabet < 0.5:
        raise AssertionError("the served model does not follow its training corpus")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import core
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.paged_attn import entry
    from repro_torch.models.model import init_params
    from repro_torch.sparse_infer import export_compressed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("phase 1: device and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    log(f"  host: {host_cpu()}, {os.cpu_count()} cores (serving steps are host-bound)")
    t0 = time.perf_counter()
    out = dispatch.build()
    dispatch.load_kernels()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s into {out}")
    for name in dispatch.SOURCES:
        log_file = out / f"{name}.log"
        for line in (log_file.read_text().splitlines() if log_file.exists() else []):
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("phase 2: kernels against their plain versions (gpt2-paper shapes)")
    cfg = get_config("gpt2-paper")
    params = init_params(cfg, seed=0, device=dev)
    recipe = core.make_recipe("step", core.SparsityConfig(default=core.NMSparsity(2, 4)))
    comp, _ = export_compressed(params, recipe)
    first = check_first_body_bytes(torch, dev)
    records = {"nm_spmm": check_nm_spmm(torch, comp, dev),
               "paged_attn": check_paged_attn(torch, dev, "gqa", first),
               "nm_mask": check_nm_mask(torch, dev)}
    log("phase 2: the batched nm_spmm and paged_attn's MLA form (DeepSeek-V2-Lite shapes)")
    records["nm_spmm_batched"] = check_nm_spmm_batched(torch, dev)
    records["paged_attn_mla"] = check_paged_attn(torch, dev, "mla", first)
    log("phase 2: paged_attn's window form (RecurrentGemma-9B shapes)")
    records["paged_attn_win"] = check_paged_attn(torch, dev, "window", first)
    log("phase 2: paged_attn's int8 forms (K2q) at the shapes of its GQA, MLA and window forms")
    records["paged_attn_q"] = check_paged_attn(torch, dev, "gqa", first, int8=True)
    records["paged_attn_mla_q"] = check_paged_attn(torch, dev, "mla", first, int8=True)
    records["paged_attn_win_q"] = check_paged_attn(torch, dev, "window", first, int8=True)
    log("phase 2: paged_attn's stats form (K3) in its six forms, and split over 2 and 4 page "
        "ranges against K2")
    for form in ("gqa", "window", "mla"):
        for int8 in (False, True):
            name = entry(mla=form == "mla", window=form == "window", stats=True, quant=int8)
            records[name] = check_paged_attn_stats(torch, dev, form, first, int8)

    log("phase 3: serve full-width gpt2-paper: slab, undersized paged pool, int8 pool of "
        "the same bytes")
    launches, single = serve_phase(torch, cfg, comp, dev, dispatch)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        log("phase 4: train full-width gpt2-paper with STEP (2:4, batch 8, seq 128, 60 steps)")
        launches["nm_mask"] = train_phase(torch, dev, dispatch, ckpt_dir)["nm_mask"]
        log("phase 5: serve the trained checkpoint, compressed")
        serve_trained_phase(torch, cfg, dev, dispatch, ckpt_dir)

    log("phase 6: serve full-width DeepSeek-V2-Lite (27 layers): slab, paged, preempting, "
        "int8 pool")
    launches.update(deepseek_phase(torch, dev, dispatch))

    log("phase 7: serve full-width RecurrentGemma-9B (38 layers): slab, paged, preempting, "
        "int8 pool")
    rg = recurrentgemma_phase(torch, dev, dispatch)
    launches["paged_attn_win"] = rg["paged_attn_win"]
    launches["paged_attn_win_q"] = rg["paged_attn_win_q"]

    log(f"phase 8: serve full-width gpt2-paper tensor-parallel on {MESH_RANKS} ranks of the "
        "one card: phase 3's fp and int8 pools")
    launches.update(mesh_phase(torch, cfg, comp, dev, single))
    del comp

    kernels = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}.cu", "replaces": replaces,
            "launches": launches[name], **{k: rec[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "at")},
            **{k: rec[k] for k in ("sdpa_yardstick_ms", "splits", "first_version_bytes")
               if k in rec},
        })
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
