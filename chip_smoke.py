#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``.
Phases, in order; any failure exits non-zero:

1. Device: print the card's ``nvidia-smi`` name and power limit; build the
   CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source, or
   per part of ``paged_attn.cu``, all in parallel).
2. Kernels against their plain PyTorch versions, at the shapes the
   full-width gpt2-paper paths give them: ``nm_spmm`` and ``paged_attn`` in
   bf16 within one bf16 rounding step, ``nm_mask`` bit-exact in bf16 and
   f32 (and on ties, all-zero groups, 1:4, 2:8, 4:16); then CUDA-event
   timings of the kernel, the plain version and, where one exists, a
   one-call PyTorch yardstick, beside the least time the card could take
   (the larger of bytes / 3.35 TB/s and operations / 989 TFLOP/s, counted
   from the shapes).  ``nm_spmm`` (K1) runs its decode kernel for B <= 8
   rows (a ring of kept weight rows in flight per lane) and, for more rows
   of bf16 x, its tensor-core body (expanded tiles, ``mma.sync``), each
   summing every output in one order fixed by the weight's shapes: every
   K1 call runs twice and must give the same bytes, and 32 rows of a
   prefill (its first, and from the middle of a 512-row call) the bytes of
   a prefill call of those rows alone.  K1 is also
   timed at RecurrentGemma-9B's MLP widths (4096->12288, 12288->4096) at B
   = 4, with its rate in GB/s, and at B = 2048 (prefill), held against its
   plain version and timed beside ``torch.matmul`` with its rate in
   TFLOP/s.
3. Serve full-width gpt2-paper (random weights from a seed, STEP 2:4
   export, compression) through ``DecodeEngine``: on the slab, then on an
   undersized paged pool that preempts.  Launch counts are zeroed before
   and read after; both kernels must have run.  Every request must finish
   with its token budget.  Then the same traffic on an
   int8 pool (``kv_quant``) of no more device bytes than the fp pool
   (about twice its pages): ``paged_attn``'s int8 form must launch 12
   times per decode step and the fp form never, and the pool must preempt
   fewer times than the fp pool.  The stream gate: the same traffic served
   by f32 twins of the tree (every float leaf in f32) on the slab, the
   preempting pool and the int8 pool (the same preemptions); the slab and
   paged twins' greedy streams must be equal except where the top-2
   margin, read from an f32 forward, is under 0.1, and every token of
   both must lie within 0.1 of that forward's greedy choice (the bf16
   streams' differences are printed as readings, their margins read in
   f32).  Then
   a ``torch.profiler`` trace of a few decode steps on a 28-page fp and
   int8 pool (device ms a step by kernel).
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
6. Serve full-width DeepSeek-V2-Lite (its first 8 of 27 layers: MLA,
   64-expert MoE):
   random weights from seed 0, the STEP 2:4 export and compression leaf by
   leaf, then 8 greedy requests of 64 + 32 tokens over 4 lanes, K = 4, on
   the slab, on a paged pool that never preempts and on an undersized
   pool that preempts, then on an int8 pool of the first pool's 28
   pages.  Launch counts are zeroed before and read after each run: the
   batched ``nm_spmm`` must launch 3 x 7 times per decode step
   and per prefill batch, and ``paged_attn``'s MLA form (its int8 form on
   the int8 pool) 8 times per paged decode step.  Then a
   ``torch.profiler`` trace of a few decode steps on the fp and the int8
   pool.  The stream gate, once the bf16 runs' engines are freed: the f32
   twin of the first 4 layers (the dense one and 3 MoE layers) on the slab
   and the 28-page pool, streams equal
   except at f32 top-2 margins under 0.1 (MoE capacity makes a forward's
   dropped tokens depend on its length, so the tokens are not held to the
   forward's choices one by one here).  The eight prompts share their
   first 48 tokens, and a fifth run serves them on the 28-page pool with
   chunked prefill (chunks of 32) and the prefix cache: the batched
   ``nm_spmm`` must launch 3 x 7 times per chunk dispatch too, the index
   must hit, and no page or reference may be left after ``clear()``; its
   f32 twin and a cold one, both with an MoE capacity of every token (so
   that only the chunks and the hits part them), go through the stream
   gate, and ``prefill_chunk`` on the first 4 layers in f32, chunk by
   chunk, must give a forward's last logits within 1e-3.
7. Serve full-width RecurrentGemma-9B (its first 8 of 38 layers: 2 x
   (RG-LRU, RG-LRU, local MQA) + 2 RG-LRU): random weights from seed 0, the STEP
   2:4 export and compression leaf by leaf, then 4 greedy requests of
   2100, 2032, 1200 and 64 prompt tokens (prefilled at exact lengths) + 48
   generated over 4 lanes, K = 4, max_len 2176 (so the attention layers
   take the 2048-token window: a rolling slab, a modular page table), on
   the slab, on a 520-page pool that never preempts (it must hold only the
   window table and evict pages), on a 340-page pool that
   preempts and on a 520-page int8 pool (which must evict as the fp one
   does).  ``nm_spmm`` must launch 54 times per decode step and per
   prefill batch, ``paged_attn``'s window form (its int8 form on the int8
   pool) twice per paged decode step, and no other attention kernel.  The two decode routes from one
   state past the window must agree within 1e-3 in f32 over the first
   period and the tail (the bf16 difference at the phase's depth is
   printed as a reading).  Then a ``torch.profiler`` trace of a few decode steps on the
   fp and the int8 pool, with the device ms a step of K2w's walk and
   combine and of K1's decode kernel.  The stream gate: the f32 twin of
   the first period and the tail (5 layers) on the slab and the 520-page
   pool, as in phase 6.

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

8. Serve every family tensor-parallel: two ranks (``launch.mesh.run_ranks``,
   ``gloo`` since they share the one card; one spawn, each rank exporting
   each tree itself from seed 0, ``launch.serve.serve_jobs``) each keep
   their slice of every compressed leaf that the placements split, their
   vocab slice of ``tok_embed``, and their rows of every lane of the slab
   or their page range of a pool plus a sink page.  Full width, cut in
   depth: gpt2-paper's first 4 of 12 layers on phase 3's traffic (slab,
   its 22-page fp pool, its 44-page int8 pool), DeepSeek-V2-Lite's first 4
   layers (4 prompts of 64 + 16 tokens: slab, 28-page fp and int8 pools;
   the absorbed MLA decode on every layout, K3's MLA form on the pools,
   the expert stacks through K1b's reduction-sharded route),
   RecurrentGemma-9B's first period (rec, rec, attn) on phase 7's prompts
   past its 2048 window with 32 tokens (slab: a window ring of 1,024 rows
   a rank, the RG-LRU state's columns split; fp and int8 pools, K3's
   window form), Mamba2-2.7B's first 4 layers (slab, table-less pool; the
   SSM heads split over the ranks).  Per rank and run: K3's form of the
   pool once an attention layer and paged decode step and no K2, K2m, K2w
   or K2q launch; K1 and K1b at their counts a forward; the collectives a
   decode step; every rank's streams, host page tables and one forward's
   logits identical; no compressed leaf that the placements split held
   whole.  Prints ms a step, tok/s, collectives and the host time inside
   them, and each rank's weight and KV bytes.  The stream gate: the ranks
   serve each run again as the f32 twin (DeepSeek's with an MoE capacity
   of every token; all but RecurrentGemma-9B's int8 pool, whose 2,100-row
   prefills cost the most) and its streams must equal the single-rank f32
   twin's, served here on the same run, except at f32 top-2 margins under
   0.1 (the tokens of slab and fp runs but DeepSeek's also each within 0.1
   of the f32 forward's greedy choice), and every leaf of the ranks'
   caches must have the shape its placement gives the single rank's;
   DeepSeek's f32 forward logits on each rank within 1e-4 (atol and rtol)
   of the single rank's.

10. Serve full-width gpt2-paper (phase 3's tree) with chunked prefill and
   the prefix cache.  ``prefill_chunk`` in f32 at full depth, chunks of 64
   of four prompts (320, 257, 200, 129), on the slab and a pool: each
   lane's last chunk's logits within 1e-3 of one forward's; a profiler
   trace of one chunk dispatch of 4 x 64 rows must show 72 K1 launches.
   Six requests of 320, 257, 200, 129, 64 and 40 prompt tokens + 32 over
   4 lanes, K = 4, chunks of 64, on the slab, an 80-page fp pool and an
   int8 pool of no more bytes, each against the same engine without
   chunking; then two waves of 4 requests sharing a 136-token head (tails
   of 8-40 tokens) on the fp and int8 pools, with and without the prefix
   cache, and once by the device scheduler (16 steps, 2 staged lanes, two
   dispatches a cycle) with chunks of 64.  Every sync run's K1 launches
   must be exactly 72 per forward (decode step, prefill batch, chunk
   dispatch), the device run's per iteration and forward; each prefix
   run must hit 4 times for at least 4 x 128 tokens and leave no page or
   reference after ``clear()``.  The stream gate: the f32 twins of chunked
   against monolithic (each pool), of prefix hits against cold (fp and
   int8) and of the device run against the sync cold run; the bf16 streams
   are readings.

11. Serve with self-speculative decoding (``spec_gamma``): the drafter a
   compressed tree, the verifier its masked-dense tree (or a denser N:M
   artifact), a round = up to gamma decode steps of the drafter and one
   chunked verify pass.  Full-width gpt2-paper, phase 3's first 4 prompts
   + 32 tokens: (a) the 2:4 drafter against its masked-dense verifier,
   gamma 4, on the slab, a 28-page fp pool and a 28-page int8 pool; (b)
   a seed-1 2:4 drafter, gamma 3, on the fp pool, which must reject; (c)
   the seed-0 4:8 compressed verifier against the 2:4 drafter, gamma 4
   ((b) and (c) with budgets of 20 tokens, about a token a round; (b)
   must reject and its rollbacks must drop pages):
   its verify chunk of 4 x 5 rows runs K1's tensor-core body, 72
   ``nm_spmm_tc`` launches in its first verify pass, which runs under the
   profiler, and K1 at that chunk's shapes (one layer's six 4:8 leaves,
   20 bf16 rows) must agree with its plain version within one bf16 step;
   (d) (a) with chunks of
   64 and the prefix cache on phase 10's shared-head waves (80 pages);
   (e) a sampled run (temperature 0.9, top-k 40) in which every request
   ends on its budget.  Full-width DeepSeek-V2-Lite on its first 4
   layers (phase 6's tree), gamma 3 on the 28-page pool.  Each round's
   launches are read around its draft scan and its verify pass: K1 72 x
   the drafted steps (max gi), K2 or K2q 12 x them on pools, K1 72 in a
   compressed verifier's pass and none in a dense one's; DeepSeek's K1b 9
   and K2m 4 a drafted step.  The gate: each run (a)-(d) and DeepSeek
   again with f32 twins, its streams against the plain engine serving the
   f32 verifier through the stream gate (the slab's against the fp
   pool's plain run, the same f32 function; DeepSeek with an MoE capacity
   of every token, since a verify chunk's token count is not a decode
   step's), and after every round each live lane's committed K/V within
   1e-4 of a verifier forward's over its tokens (slab and fp pools; on
   int8 pages a reading); every pool run leaves no page or reference.
   Readings: acceptance, tokens a round, ms a round and a token beside
   the plain verifier's, the bf16 streams against its.

12. Serve the reference's other token archs at full width (random weights
   from seed 0, the STEP 2:4 export and compression leaf by leaf).
   starcoder2-3b (its first 8 of 30 layers, GQA 24 over 2 KV heads of
   128, q/k/v/o biases): phase 3's traffic on the slab, a 28-page fp pool
   and a 28-page int8 pool; K1 exactly 48 launches per decode step and
   prefill batch, K2 8 per paged decode step on the fp pool, K2q 8 on the int8
   pool (where K2 never runs), nothing else.  minitron-4b's first 4 of 32
   layers (GQA 24 over 8): the same traffic on the fp pool, K1 24 and K2 4.
   Each arch's f32 twins on the slab and the fp pool through the stream
   gate.  mamba2-2.7b (its first 16 of 64 layers): 4 requests of 200, 128, 100 and 64
   prompt tokens + 32, prefilled at exact lengths, on the slab and on the
   pool without tables (no page, no attention kernel), then by the device
   scheduler over 3 lanes (16 steps a dispatch, the fourth request staged:
   it refills a lane inside the loop); K1 exactly 32 launches per decode
   step, prefill batch and loop iteration.  In f32, a prefill then 8
   decode steps against one forward within 1e-3; the f32 twins of the
   slab and the device run through the stream gate.  Each arch logs which
   K1 body its calls take (decode kernel, tensor-core tile or the first
   version's body), and K1 runs at starcoder2's MLP widths (its 12,288-deep
   ``w_proj`` at 4 bf16 rows fills the decode kernel's 96 KB staging
   exactly) and mamba2's ``w_in`` (10,576 columns: tensor-core tail tiles)
   and ``w_out``, against its plain version.  Readings: ms a decode step,
   mamba2's prefill seconds by prompt length, its state bytes a lane, peak
   memory.

13. The stub-frontend archs at full width (random weights from seed 0,
   the STEP 2:4 export and compression leaf by leaf).  First K2 and K2q
   at their heads, G = 6 over 2 KV heads of 128 and MHA at 32 heads of 64,
   both flushes, against their plain versions and timed beside SDPA and
   their bound (the ``phase13_heads`` entries of their rows).
   qwen2-vl-2b (its first 8 of 28 layers, GQA 12 over 2 heads of 128, M-RoPE, tied
   151,936-row embedding): K1 at ``frontend_proj`` (1176 -> 1536: a K
   that ends 24 columns into its last 64-column step) at 9, 256 and 200
   bf16 rows and 4 f32 rows against its plain version, timed at 256 rows
   beside ``torch.matmul`` on the decompressed weight (``frontend_proj``
   in K1's row); a forward over stub embeddings (2 x 128 rows) through
   the compressed tree with exactly 1 + 7 x 8 K1 launches, its bf16
   logits against the masked-dense tree's as a reading, and the f32 twins
   of the first 4 layers, compressed against masked-dense, within 1e-3;
   then phase 3's traffic on the slab and 28-page fp and int8 pools (K1
   56 per decode step and prefill batch, K2 or K2q 8 per paged step,
   nothing else) and the f32 twins of the slab and the fp pool through
   the stream gate.  musicgen-large (its first 8 of 48 layers, MHA 32 x
   64, GeLU, untied): the same with ``frontend_proj`` 512 -> 2048, K1 6 a
   layer and K2 8 a paged step, on the slab and the fp pool.  qwen2-vl-2b trained
   through the train CLI's stub branch (10 STEP steps, batch 2 x 128
   rows of bf16 embeddings drawn on the card): the loss finite and
   falling, t0 inside AutoSwitch's clip, ``nm_mask`` exactly 8 per masked
   step and 8 at export, the export exactly 2:4.  DominoSearch (m = 8,
   kept share 0.5) on qwen2-vl-2b's tree on the card, timed, its
   histogram of n logged (on the whole 28-layer tree); the n:8 export (``nm_mask`` once a leaf slice
   below 8:8) with every leaf at its assigned n; K1 at the first layer's
   n:8 leaves (4 and 64 rows) and ``nm_mask`` at each assigned n against
   their plain versions; 4 prompts of 64 + 16 tokens served on the slab
   (K1 exactly 196 per forward), and the f32 twins of the n:8 tree and
   its masked-dense tree: a forward within 1e-3 and the served streams
   through the stream gate.  Each part's seconds are logged.

Each phase's seconds are logged, and the total beside them.

Phase 2 also holds K2 and K2q (GQA, fp and int8 pages) at phase 12's head
shape, D = 128 with G = 12 and G = 3, in both flushes, against their plain
versions, timed beside their bound and SDPA (the ``d128`` entry of their
rows in the kernels line).

Phase 2 also holds K3, the stats flush of ``paged_attn``, in all six
forms (GQA, window, MLA; fp and int8 pages) at K2's, K2w's and K2m's
shapes: ``(acc, m, l)`` against its plain version in f32, dead lanes
exactly ``(0, -1e30, 0)``, then each form's pool split into 2 and 4 page
ranges, K3 on each range and the combine, against K2 on the whole pool;
timed beside its bound and its plain version (no one PyTorch call returns
unnormalized flash stats: SDPA is timed as a yardstick only).  K3's
window forms run K2w's split walk and combine, with the stats flush.
Every K3 row's launches are phase 8's ranks' (GQA: gpt2-paper, window:
RecurrentGemma-9B, MLA: DeepSeek-V2-Lite).  Phase 2 also times K1b's
reduction-sharded route: a rank's launch on its half-K slices of one MoE
layer's stacks at C = 8 and 32 beside its bound and ``torch.bmm`` on the
same slices, the two halves' sum held against the plain version (the
``sharded`` entry of K1b's row).

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
# K1's and K1b's prefill times at phase 2's shapes with the first version's
# body, which the tensor-core body replaced, for the log only: PERF.md §6's
# table (H100 80GB HBM3, 700 W), not measured by this script
K1_PREFILL_EARLIER_MS = {"wq": 0.0470, "w_fc": 0.0965, "w_proj": 0.1680}
K1B_PREFILL_EARLIER_MS = {2048: 0.7879, 1408: 0.7802}
# the commit whose GQA/MLA kernel wrote the digests of kernels/paged_attn_check.py
FIRST_BODY = "064ba4a"
# live pages a lane at which phase 2 times the GQA and MLA body (log only)
LIVE_PAGES = (0, 1, 2, 4, 7)
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
# K3's forms: phase 8 reads each one's launches from its ranks (GQA:
# gpt2-paper's pools, window: RecurrentGemma-9B's, MLA: DeepSeek-V2-Lite's)
K3_FORMS = tuple(name for name in KERNEL_ROWS if "_stats" in name)
# The depths at which phases 6, 7, 12 and 13 serve their archs at full
# width: each arch's first layers.  A serving step is host-bound, so a
# run's seconds go with its depth; the whole depths (DeepSeek-V2-Lite 27,
# RecurrentGemma-9B 38, starcoder2-3b 30, mamba2-2.7b 64, qwen2-vl-2b 28,
# musicgen-large 48) took most of the script's time limit.
# DeepSeek-V2-Lite's first 8: layer 0 with its dense MLP, then 7 MoE
# layers, each with 3 batched nm_spmm launches (gate, up, down)
DS_MOE_LAYERS, DS_LAYERS = 7, 8
# RecurrentGemma-9B's first 8: two periods (RG-LRU, RG-LRU, local MQA)
# and two RG-LRU layers of the tail
RG_LAYERS = 8
# starcoder2-3b, qwen2-vl-2b and musicgen-large (phases 12 and 13)
ARCH_LAYERS = 8
# mamba2-2.7b (phase 12)
MAMBA_LAYERS = 16
# In f32 the two decode routes differ only in summation order (absorbed
# W_uk/W_uv against expanded K/V): about 1e-6 of a logit over 4 layers on
# an H100.
DS_ROUTE_F32_TOL = 1e-3
# RecurrentGemma-9B serving (phase 7): per forward (a prefill batch or a
# decode step) K1 runs 5 RG-LRU projections + 2 MLP matmuls in each
# recurrent layer and q/k/v/o + 2 MLP matmuls in each local-attention
# layer; K2w once per attention layer and paged step.
RG_K1_REC, RG_K1_ATTN = 7, 6
# prompts past the window (2100), crossing position 2048 while decoding
# (2032), short of it (1200) and short (64); max_len 2176 >= the window, so
# the attention layers take the modular window table
RG_PROMPTS, RG_GEN, RG_MAX_LEN = (2100, 2032, 1200, 64), 48, 2176
# 4 lanes x the 130-slot window table never preempts; 340 pages admit all
# four prompts (338) and run short as the two shorter lanes grow
RG_PAGES, RG_PAGES_PREEMPTING = 520, 340
# the f32 routes from one state differ only in summation order
RG_ROUTE_F32_TOL = 1e-3
# phase 7's f32 twins: the first period (rec, rec, attn) and the tail
RG_TWIN_BODY = 1
# the training run of phase 4; the switch is forced at t_max + 1 = 31 since
# the AutoSwitch window (T_w = 50 at b2 = 0.98) is not yet full by then
TRAIN_ARGS = ["--no-smoke", "--recipe", "step", "--nm", "2:4", "--batch", "8", "--seq", "128",
              "--b2", "0.98", "--steps", "60", "--lr", "3e-3", "--ckpt-every", "30"]
# gpt2-paper's maskable leaves, stacked (L, in, out): wq wk wv wo, w_fc, w_proj
MASK_LEAVES = {(12, 768, 768): 4, (12, 768, 3072): 1, (12, 3072, 768): 1}
# gpt2-paper per forward: K1 for q/k/v/o, fc and proj in each layer
GPT2_K1_PER_LAYER = 6
# phase 8's model axis: ranks that share the one card; the layers of
# gpt2-paper and Mamba2-2.7B it serves (DeepSeek's 4 and RecurrentGemma's
# first period are the f32 twins' of phases 6 and 7), the tokens each
# request generates (DeepSeek's fewer: its MoE collectives are the
# largest), and its f32 forward logits' tolerance against one rank's
# (the reference's, test_sharded_serving.py:170-172)
MESH_RANKS = 2
MESH_LAYERS, MESH_GEN, MESH_DS_GEN = 4, 32, 16
MESH_LOGIT_TOL = 1e-4
# phase 9, the device scheduler: steps a dispatch; the exact gate's
# budgets of 4 requests (phase 3's first 4 prompts) and its pools' pages
DEV_K, EXACT_BUDGETS, EXACT_PAGES = 16, (32, 29, 24, 17), 28
# RecurrentGemma's device run (phase 7): 8 steps a dispatch keep its
# capture short
RG_DEV_K = 8
# empty spin kernels that open every torch.profiler window (open_trace)
LEAD_KERNELS = 2048
# phase 10, chunked prefill and the prefix cache on gpt2-paper: the chunk,
# the chunked traffic's prompts (a last chunk of 1 token at 257, one chunk
# exactly at 64, unchunked at 40), its pool (the four longest lanes need 67
# 16-token pages: no preemption); the prefix traffic's shared head (8 whole
# pages and 8 tokens of a ninth), its tails' range and its pool
CHUNK, CHUNK_PROMPTS, CHUNK_PAGES = 64, (320, 257, 200, 129, 64, 40), 80
PREFIX_HEAD, PREFIX_TAILS, PREFIX_PAGES = 136, (8, 40), 80
# prefill_chunk's last logits against one forward's, f32 at full width: the
# routes' summation orders differ by 1e-6 to 5e-6 of a logit
CHUNK_F32_TOL = 1e-3
# DeepSeek in phase 6: its chunk, and the head its prompts share
DS_CHUNK, DS_HEAD = 32, 48
# phase 11, self-speculative decoding: the draft lengths of runs (a), (c),
# (d), (e) and of run (b) and DeepSeek's, the pool of phase 3's first 4
# prompts (4 lanes x 7 pages of 16: no preemption), the sampled run's policy
SPEC_GAMMA, SPEC_GAMMA_REJECT, DS_SPEC_GAMMA, SPEC_PAGES = 4, 3, 3, 28
# the budget of runs (b) and (c), whose drafts are mostly rejected (a
# token a round): 20 takes the lanes of 64-token prompts across a page
# boundary, whose page each round maps and a rejection rolls back
SPEC_GEN_REJECTED = 20
SPEC_TEMPERATURE, SPEC_TOP_K = 0.9, 40
# a lane's committed K/V against a verifier forward's, f32: the routes sum
# in other orders
SPEC_KV_F32_TOL = 1e-4
# DeepSeek's spec run: its first 4 layers (the dense one and 3 MoE layers)
DS_SPEC_BODY = 3
# phase 6's f32 twins: the same first 4 layers
DS_TWIN_BODY = 3
# phase 12, the reference's other token archs at full width: starcoder2-3b
# (GQA 24 over 2 KV heads of 128) and minitron-4b's first 4 of
# 32 layers (GQA 24 over 8; its 256,000-token vocabulary makes its whole
# depth too costly for the script's time limit): K1 runs q/k/v/o and the
# GeLU MLP's two matmuls in each layer (``k1_per_layer``), K2 (K2q on int8
# pages) once a layer and paged decode step; phase 3's traffic on pools of
# 4 lanes x 7 pages of 16 (no preemption)
MT_LAYERS, ARCH_PAGES = 4, 28
# mamba2-2.7b: K1 runs w_in and w_out in each layer; its prompts,
# prefilled at exact lengths (one SSD chunk each), their budget, and the
# device run's lanes (the fourth request waits staged and refills a lane)
MAMBA_K1_PER_LAYER, MAMBA_PROMPTS, MAMBA_GEN, MAMBA_DEV_LANES = 2, (200, 128, 100, 64), 32, 3
# the f32 SSM decode route from a prefilled state against one forward: the
# recurrence and SSD sum in other orders
MAMBA_ROUTE_F32_TOL = 1e-3
# phase 13, the stub-frontend archs at full width: a forward over embeds of
# 2 x 128 rows, the f32 twins of its first 4 layers; the training run
# (the switch forced at t_max + 1 = 6: AutoSwitch's 50-step window is not
# full by then); DominoSearch's group size and kept share, and its served
# run's prompts (of 64 tokens) and budget; K2 and K2q at the archs' heads
# (G, Hkv, D)
FRONT_ROWS, FRONT_TWIN_BODY = (2, 128), 4
FRONT_TRAIN_ARGS = ["--arch", "qwen2-vl-2b", "--no-smoke", "--recipe", "step", "--nm", "2:4",
                    "--steps", "10", "--batch", "2", "--seq", "128"]
DOMINO_M, DOMINO_DENSITY, DOMINO_PROMPTS, DOMINO_GEN = 8, 0.5, 4, 16
FRONT_HEADS = ((6, 2, 128), (1, 32, 64))


def log(msg: str) -> None:
    print(msg, flush=True)


def open_trace(torch) -> None:
    """Start a ``torch.profiler`` window with ``LEAD_KERNELS`` empty spin
    kernels.  CUPTI leaves the start timestamp of a window's first activity
    records at 0, and kineto drops those records as outside the window:
    more of them with each window a process opens, now and then many at
    once (torch 2.11 on an H100), until they reach the traced work's own
    kernels.  The spin kernels take their places; ``traced_kernels``
    leaves them out of every reading."""
    for _ in range(LEAD_KERNELS):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()


def traced_kernels(prof) -> tuple[list, int]:
    """The CUDA events of a window that ``open_trace`` opened, without its
    spin kernels, and how many of the spin kernels' records kineto dropped
    (all of them: the traced work may have lost records too)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kept = sum(e.count for e in events if "spin_kernel" in e.key)
    return [e for e in events if "spin_kernel" not in e.key], LEAD_KERNELS - kept


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


def layer_leaves(comp: dict) -> dict:
    """The six compressed matmuls of a gpt2-paper tree's first layer."""
    layer = comp["body"]["sb_0"]
    leaves = {k: layer["attn"][k].layer(0) for k in ("wq", "wk", "wv", "wo")}
    leaves.update({k: layer["mlp"][k].layer(0) for k in ("w_fc", "w_proj")})
    return leaves


def check_nm_spmm(torch, comp: dict, dev) -> dict:
    """K1 at the six matmuls of one gpt2-paper layer (q/k/v/o 768->768,
    fc 768->3072, proj 3072->768), in decode (B = 1, 4, 8: the decode
    kernel) and prefill (B = 4 x 64 rows: the tensor-core body), each call
    twice (the same bytes; the prefill's rows 0-31, and rows 70-101 and
    300-331 of a B = 512 call, across warps and row tiles, also the bytes
    of a prefill call of those rows alone); then at RecurrentGemma-9B's MLP
    widths (4096->12288, 12288->4096) in decode (B = 4) and prefill (B =
    2048), with their rates.  The record is one layer's six decode calls at
    B=4, and under ``prefill`` the three distinct prefill shapes at B=256."""
    from repro_torch.kernels.nm_spmm import nm_spmm, nm_spmm_plain

    leaves = layer_leaves(comp)
    gen = torch.Generator(device=dev).manual_seed(1)
    rec = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    prefill = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for b in (1, 4, 8, 256):
        for name, w in leaves.items():
            k_dim = w.values.shape[0] * w.m // w.n
            x = torch.randn((b, k_dim), generator=gen, device=dev).to(torch.bfloat16)
            args = (x, w.values, w.indices, w.n, w.m, w.out_features)
            label = f"nm_spmm {name} B={b} ({k_dim}->{w.out_features})"
            y = nm_spmm(*args)
            same_bytes(torch, label, y, nm_spmm(*args))
            if b == 256:  # a row's bytes depend neither on the rows beside it
                same_bytes(torch, f"{label} rows 0-31 alone", y[:32],  # nor on its place
                           nm_spmm(x[:32].contiguous(), *args[1:]))
                rows_alone(torch, f"nm_spmm {name} B=512", nm_spmm,
                           torch.cat([x, x.flip(0)]), args[1:], (70, 300))
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
            log(f"  time nm_spmm {name} B={b}: kernel {t['ms']:.4f} ms"
                f"{f' (the first version: {K1_PREFILL_EARLIER_MS[name]} ms)' if b > 8 else ''}, "
                f"plain {t['plain_ms']:.4f} ms, torch.matmul(dense) {t['library_ms']:.4f} ms, "
                f"bound {t['bound_ms']:.4f} ms ({by})")
            into = rec if b == 4 else prefill
            for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                into[key] += t[key]
            into["bound_by"] = by
    rec["at"] = "sum of one layer's six decode calls, x (4, K) bf16, 2:4"
    prefill["at"] = "sum of wq, w_fc and w_proj at x (256, K) bf16, 2:4"
    rec["prefill"] = prefill
    for k_dim, o in ((4096, 12288), (12288, 4096)):  # RecurrentGemma-9B's MLP
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
        rec["max_abs_err"] = max(rec["max_abs_err"], rg_prefill(torch, k_dim, o, gen, dev))
    return rec


def rows_alone(torch, label: str, fn, x, args: tuple, starts: tuple, rows: int = 32) -> None:
    """``rows`` rows of x from each start (on the row axis, -2) give in a
    call of just those rows the bytes they gave in ``fn(x, *args)``."""
    y = fn(x, *args)
    for lo in starts:
        part = x[..., lo:lo + rows, :].contiguous()
        same_bytes(torch, f"{label} rows {lo}-{lo + rows - 1} alone", y[..., lo:lo + rows, :],
                   fn(part, *args))


def rg_prefill(torch, k_dim: int, o: int, gen, dev) -> float:
    """K1's tensor-core body at one RecurrentGemma-9B MLP matmul in prefill
    (B = 2048), against its plain version, twice (the same bytes), rows
    0-31, 70-101 and 1000-1031 alone (their bytes), timed beside
    ``torch.matmul``, its bound and
    its rate.  The values are at the model's init scale (standard
    deviation K^-1/2): with unit values, f32 sums of 2,048 products of
    that size in two orders differ near 0 by more than the check's 1e-5
    floor, in the first version's body as in this one (PERF.md §6).
    Returns the largest error."""
    from repro_torch.kernels.nm_spmm import nm_spmm, nm_spmm_plain

    b = 2048
    vals, idx = random_stack(torch, 1, k_dim, o, gen, dev)
    vals = (vals.float() * k_dim ** -0.5).to(torch.bfloat16)
    x = torch.randn((b, k_dim), generator=gen, device=dev).to(torch.bfloat16)
    args = (x, vals[0], idx[0], 2, 4)
    label = f"nm_spmm B={b} ({k_dim}->{o})"
    y = nm_spmm(*args)
    same_bytes(torch, label, y, nm_spmm(*args))
    rows_alone(torch, label, nm_spmm, x, args[1:], (0, 70, 1000))
    err = check_close(label, y, nm_spmm_plain(*args))
    dense = torch.zeros((k_dim // 4, 4, o), dtype=torch.bfloat16, device=dev)
    dense.scatter_(1, idx[0].long().reshape(k_dim // 4, 2, o), vals[0].reshape(k_dim // 4, 2, o))
    dense = dense.reshape(k_dim, o)
    ms = time_ms(torch, lambda: nm_spmm(*args))
    lib_ms = time_ms(torch, lambda: torch.matmul(x, dense))
    nbytes = x.numel() * 2 + vals.numel() * 3 + b * o * 2
    flops = 2.0 * b * vals.numel()
    bound, by = bound_ms(nbytes, flops)
    log(f"  time nm_spmm B={b} {k_dim}->{o} (RecurrentGemma-9B MLP, prefill): kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s of kept products), torch.matmul(dense) {lib_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({by})")
    return err


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


def gqa_case(torch, dev, int8: bool, h: int = 12, g: int = 1, d: int = 64) -> AttnCase:
    """K2's GQA form at B=4, ps=16, ``h`` KV heads of ``d`` with ``g`` query
    heads each (phase 2's gpt2-paper shape by default: 12 heads of 64,
    G = 1): ragged lanes, sentinel slots, one dead lane; bf16 queries over
    bf16 pages (``int8``: the port's int8 codes and scales of the same
    pages)."""
    import torch.nn.functional as F

    b, ps, n_slots, num_pages = 4, 16, 7, 40
    lengths = [97, 33, 0, 70]
    gen = torch.Generator(device="cpu").manual_seed(2)
    tables = _tables(torch, lengths, ps, n_slots, num_pages, gen)
    q, kp, vp = (torch.randn(s, generator=gen).to(torch.bfloat16).to(dev) for s in (
        (b, h, g, d), (num_pages, ps, h, d), (num_pages, ps, h, d)))
    (kp, vp), (ks, vs), (kv, vv) = int8_pages(torch, (kp, vp), int8)
    tables, lens = tables.to(dev), torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(scale=d ** -0.5, k_scale=ks, v_scale=vs)
    # yardstick: SDPA on the pre-gathered contiguous (B, H·G, S, D) view
    # (pre-dequantized to bf16 for int8 pages, each KV head repeated G times)
    phys = tables.long().clamp(max=num_pages - 1)
    kg, vg = (x[phys].reshape(b, n_slots * ps, h, d).transpose(1, 2)
              .repeat_interleave(g, dim=1).contiguous() for x in (kv, vv))
    mask = (torch.arange(n_slots * ps, device=dev)[None, :] < lens[:, None])[:, None, None]
    qs = q.reshape(b, h * g, 1, d)
    live = sum(lengths)
    label = f"B=4 H={h} D={d} ps=16" if g == 1 else f"B=4 Hkv={h} G={g} D={d} ps=16"
    return AttnCase(
        name="paged_attn" + ("_q" if int8 else ""), label=label,
        at=f"q ({b}, {h}, {g}, {d}) bf16, "
           f"{'int8 pages + f16 scales' if int8 else 'bf16 pages'}, ps=16, lengths {lengths}",
        q=q, pages=(kp, vp), tables=tables, lens=lens, kw=kw, dead=2, rtol=BF16_RTOL,
        in_bytes=(q.numel() * 2 + 2 * live * row_bytes(h * d, 2, int8) + tables.numel() * 4
                  + b * 4),
        out=b * h * g * d, heads=b * h * g, flops=4.0 * live * h * g * d, peak=BF16_FLOPS,
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


def check_gqa_heads(torch, dev, heads=((12, 2, 128), (3, 8, 128))) -> dict:
    """K2 and K2q at ``heads`` ((G, Hkv, D) each): by default phase 12's,
    D = Dv = 128 with G = 12 (starcoder2-3b, 24 query heads over 2 KV heads)
    and G = 3 (minitron-4b, 24 over 8); phase 13's are G = 6 at D 128
    (qwen2-vl-2b) and MHA at 32 heads of 64 (musicgen-large).  B = 4, ps =
    16, ragged lanes and a dead one.  Both flushes
    against their plain versions: the normalized output within one bf16
    step (the dead lane exactly zero), the stats ``(acc / l, m, l)`` within
    1e-4·|ref| + 1e-5; each timed beside its plain version, SDPA on the
    pre-gathered view (for int8 pages a yardstick only) and its bound.
    Logs ``attn_plan``'s plan of each.  Returns the records of K2 and K2q
    under ``paged_attn`` and ``paged_attn_q``, keyed by ``Hkv=<h> G=<g>
    D=<d>``."""
    from repro_torch.kernels.paged_attn import (attn_plan, paged_attn, paged_attn_plain,
                                                paged_attn_stats_plain, sm_count)

    out = {"paged_attn": {}, "paged_attn_q": {}}
    for g, h, d in heads:
        for int8 in (False, True):
            c = gqa_case(torch, dev, int8, h=h, g=g, d=d)
            args = (c.q, *c.pages, c.tables, c.lens)
            what = f"{c.name.replace('_q', ' int8')} {c.label}"
            plan = attn_plan(4, h, g, d, 0, d, 16, c.pages[0].element_size(), int8, False,
                             sm_count(dev))
            y = paged_attn(*args, **c.kw)
            err = check_close(what, y, paged_attn_plain(*args, **c.kw))
            if float(y[c.dead].abs().max()) != 0.0:
                raise AssertionError(f"{what}: the dead lane is not exactly zero")
            acc, m, l = paged_attn(*args, emit_stats=True, **c.kw)
            racc, rm, rl = paged_attn_stats_plain(*args, **c.kw)
            for part, a, ref in (("acc / l", acc / l.clamp_min(1e-30)[..., None],
                                  racc / rl.clamp_min(1e-30)[..., None]), ("m", m, rm),
                                 ("l", l, rl)):
                check_close(f"{what} stats {part}", a, ref, rtol=F32_RTOL)
            rec = dict(max_abs_err=err, plan=plan._asdict(), at=c.at,
                       ms=time_ms(torch, lambda: paged_attn(*args, **c.kw)),
                       stats_ms=time_ms(torch, lambda: paged_attn(*args, emit_stats=True,
                                                                  **c.kw)),
                       plain_ms=time_ms(torch, lambda: paged_attn_plain(*args, **c.kw)),
                       sdpa_ms=time_ms(torch, c.sdpa))
            rec["bound_ms"], rec["bound_by"] = bound_ms(c.in_bytes + c.out * 2, c.flops, c.peak)
            log(f"  time {what}: plan {plan._asdict()}; kernel {rec['ms']:.4f} ms (stats "
                f"flush {rec['stats_ms']:.4f}), plain {rec['plain_ms']:.4f} ms, "
                f"{c.sdpa_label} {rec['sdpa_ms']:.4f} ms"
                f"{' (a yardstick only: not the same function)' if int8 else ''}, bound "
                f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")
            out[c.name][f"Hkv={h} G={g} D={d}"] = rec
    return out


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
    per expert (decode: the decode kernel) and C = 32 (a 256-token prefill:
    the tensor-core body).  The record is one MoE layer's three decode
    launches, and under ``prefill`` its three prefill launches.  Each call
    runs twice: the same bytes; C = 32's rows 0-15, and rows 20-51 of a C
    = 64 call (across row tiles), also give the bytes of a call of just
    those rows."""
    from repro_torch.kernels.nm_spmm import nm_spmm_batched, nm_spmm_batched_plain

    gen = torch.Generator(device=dev).manual_seed(4)
    rec = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    prefill = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    sharded = {c: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0) for c in (8, 32)}
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
            if c == 32:  # a row's bytes depend neither on the rows beside it
                same_bytes(torch, f"{label} rows 0-15 alone", y[:, :16],  # nor on its place
                           nm_spmm_batched(x[:, :16].contiguous(), *args[1:]))
                rows_alone(torch, f"nm_spmm_batched E=64 C=64 ({k}->{o})", nm_spmm_batched,
                           torch.cat([x, x.flip(1)], dim=1), args[1:], (20,))
            err = check_close(label, y, nm_spmm_batched_plain(*args))
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            t = dict(ms=time_ms(torch, lambda: nm_spmm_batched(*args)),
                     plain_ms=time_ms(torch, lambda: nm_spmm_batched_plain(*args), reps=10),
                     library_ms=time_ms(torch, lambda: torch.bmm(x, dense)))
            nbytes = x.numel() * 2 + vals.numel() * 2 + idx.numel() + 64 * c * o * 2
            flops = 2.0 * 64 * c * (k // 2) * o
            t["bound_ms"], by = bound_ms(nbytes, flops)
            earlier = f" (the first version: {K1B_PREFILL_EARLIER_MS[k]} ms)" if c > 8 else ""
            log(f"  time nm_spmm_batched E=64 C={c} {k}->{o}: kernel {t['ms']:.4f} ms{earlier} "
                f"({nbytes / t['ms'] / 1e6:.0f} GB/s), plain {t['plain_ms']:.4f} ms, "
                f"torch.bmm(dense) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({by})")
            into = rec if c == 8 else prefill
            for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                into[key] += count * t[key]
            into["bound_by"] = by
            # the reduction-sharded route (nm_spmm_batched_sharded) on 2 ranks:
            # each rank's launch on its half-K slice against the plain version
            # of that slice; the partial outputs (bf16, as the route's) summed
            # in f32 as the all-reduce sums them, against the whole plain
            # product, a reading (each half rounds on its own)
            halves = [(x[:, :, r * k // 2:(r + 1) * k // 2].contiguous(),
                       vals[:, r * k // 4:(r + 1) * k // 4].contiguous(),
                       idx[:, r * k // 4:(r + 1) * k // 4].contiguous()) for r in (0, 1)]
            parts = [nm_spmm_batched(*h, 2, 4) for h in halves]
            for r, h in enumerate(halves):
                err = check_close(f"{label}, rank {r}'s half-K slice", parts[r],
                                  nm_spmm_batched_plain(*h, 2, 4))
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
            whole = nm_spmm_batched_plain(*args).float()
            log(f"  {label}, the 2 slices summed in f32 vs the whole plain product (reading): "
                f"max |diff| {(parts[0].float() + parts[1].float() - whole).abs().max().item():.4f}"
                f", max |whole| {whole.abs().max().item():.2f}")
            xh, vh, ih = halves[0]
            dh = dense[:, : k // 2].contiguous()
            t = dict(ms=time_ms(torch, lambda: nm_spmm_batched(xh, vh, ih, 2, 4)),
                     plain_ms=time_ms(torch, lambda: nm_spmm_batched_plain(xh, vh, ih, 2, 4),
                                      reps=10),
                     library_ms=time_ms(torch, lambda: torch.bmm(xh, dh)))
            nbytes = xh.numel() * 2 + vh.numel() * 2 + ih.numel() + 64 * c * o * 2
            t["bound_ms"], by = bound_ms(nbytes, 2.0 * 64 * c * (k // 4) * o)
            log(f"  time nm_spmm_batched E=64 C={c} {k}->{o}, a rank's half-K slice (the "
                f"sharded route): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                f"torch.bmm(dense slice) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({by})")
            for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                sharded[c][key] += count * t[key]
            sharded[c]["bound_by"] = by
        del dense
    rec["at"] = ("one MoE layer's three decode launches: x (64, 8, K) bf16, "
                 "2 x (64, 1024, 1408) + (64, 704, 2048), 2:4")
    prefill["at"] = "one MoE layer's three prefill launches at C = 32"
    rec["prefill"] = prefill
    sharded[8]["at"] = ("a rank's three launches of one MoE layer on its half-K slices "
                        "(2 ranks, nm_spmm_batched_sharded), C = 8")
    sharded[8]["prefill"] = dict(sharded[32], at="the same at C = 32")
    rec["sharded"] = sharded[8]
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


def watch_chunks(eng, records: list) -> list:
    """Count the wrappers' launches inside each chunk dispatch ``eng``
    makes: its ``_advance_chunks`` is wrapped to read ``dispatch.launches``
    just before and after every call, and a call that dispatched a chunk
    appends the entries that moved to ``records``.  Returns ``records``."""
    from repro_torch.kernels import dispatch

    inner = eng._advance_chunks

    def advance(out):
        n0, before = eng.prefill_chunks, dict(dispatch.launches)
        inner(out)
        if eng.prefill_chunks != n0:
            records.append({k: v - before.get(k, 0) for k, v in dispatch.launches.items()
                            if v != before.get(k, 0)})

    eng._advance_chunks = advance
    return records


def add_launches(total: dict, more: dict) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def check_chunk_launches(what: str, records: list, chunks: int, per_dispatch: dict) -> dict:
    """Raise unless ``records`` (``watch_chunks``) hold one entry for each of
    the run's ``chunks`` chunk dispatches, each with exactly
    ``per_dispatch``'s launches of the named entries (a value of None: at
    least one); returns the launches summed over the dispatches."""
    total: dict = {}
    for rec in records:
        add_launches(total, rec)
    bad = [rec for rec in records if any(
        rec.get(k, 0) == 0 if n is None else rec.get(k, 0) != n for k, n in per_dispatch.items())]
    log(f"  {what}: {len(records)} chunk dispatches measured ({chunks} counted by the engine), "
        f"their launches {total}; want {per_dispatch} in each")
    if len(records) != chunks or not chunks or bad:
        raise AssertionError(f"{what}: {len(records)} chunk dispatches measured, {chunks} "
                             f"counted; dispatches off {per_dispatch}: {bad[:3]}")
    return total


def serve(torch, cfg, comp, dev, *, paged: bool, n_requests=8, lanes=4, prompt_len=64,
          gen=32, k=4, num_pages=22, prompts=None, max_len=None, kv_quant=False,
          chunk_records=None, **sched):
    """One greedy serving run of the port's engine (``kv_quant``: on int8
    pages; ``sched``: the device scheduler's and the chunk path's
    arguments; ``chunk_records``: a list that gets each chunk dispatch's
    launches, ``watch_chunks``); returns (engine, prompts, streams,
    seconds)."""
    import numpy as np

    from repro_torch.serving import DecodeEngine, SamplingParams

    max_len = max_len or prompt_len + gen + 1
    eng = DecodeEngine(cfg, comp, max_batch=lanes, max_len=max_len, seed=0,
                       num_pages=num_pages if paged else None, page_size=16,
                       steps_per_dispatch=k, kv_quant=kv_quant, device=dev, **sched)
    if chunk_records is not None:
        watch_chunks(eng, chunk_records)
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


def f32_twin(torch, cfg, comp):
    """``(cfg, tree)``: the compressed tree at its depth with every float
    leaf in f32, what the stream gate serves each route with."""
    from repro_torch.launch import serve as cli

    return cli.f32_twin(cfg, comp)


def gate_streams(torch, what: str, cfg32, comp32, prompts, a, b, greedy=True) -> None:
    """The stream gate (``serving/streams.py``, at its ``MARGIN``) on two
    f32 twins' streams: raises where they differ at an f32 top-2 margin of
    ``MARGIN`` or more or, with ``greedy``, where a token of either lies
    ``MARGIN`` or more below the f32 forward's greedy choice; logs
    agree/total, the margins and the largest gap."""
    from repro_torch.serving.streams import MARGIN, check_streams

    agree, total, margins, gap = check_streams(cfg32, comp32, prompts, a, b, greedy=greedy)
    gaps = f"; largest gap below the greedy choice {gap}" if greedy else ""
    log(f"  {what}, f32 twins' greedy streams: {agree}/{total} tokens equal before each "
        f"request's first difference; f32 top-2 margins at the differences {margins}"
        f"{gaps} (all < {MARGIN})")


def stream_readings(torch, what: str, cfg32, comp32, prompts, a, b) -> None:
    """bf16 streams of two routes as a reading: agree/total and the f32
    top-2 margins at their first differences, no gate."""
    from repro_torch.serving.streams import stream_differences

    agree, total, margins = stream_differences(cfg32, comp32, prompts, a, b)
    log(f"  {what}, bf16 greedy streams (reading): {agree}/{total} tokens equal before each "
        f"request's first difference; f32 top-2 margins at the differences {margins}")


def twin_runs(torch, cfg32, comp32, dev, pools: dict, **kw) -> dict:
    """The f32 twin served on each named pool (``None``: the slab; ``(pages,
    int8)``) over the bf16 runs' traffic; returns each run's streams and
    preemptions."""
    out = {}
    for name, pool in pools.items():
        pages, int8 = pool or (None, False)
        eng, _, streams, wall = serve(torch, cfg32, comp32, dev, paged=pool is not None,
                                      num_pages=pages or 0, kv_quant=int8, **kw)
        out[name] = dict(streams=streams, preemptions=eng.preemptions, wall=wall)
        del eng
    log("  f32 twins: " + json.dumps({k: {"preemptions": v["preemptions"], "run_wall_s": v["wall"]}
                                      for k, v in out.items()}))
    return out


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
    # the gate: f32 twins of the slab and the preempting pool, the same
    # traffic, lanes, K and pool
    cfg32, comp32 = f32_twin(torch, cfg, comp)
    twins = twin_runs(torch, cfg32, comp32, dev, {
        "slab": None, "fp": (paged.layout.num_pages, False)}, prompts=prompts)
    if twins["fp"]["preemptions"] != paged.preemptions:
        raise AssertionError(f"the f32 twin preempted {twins['fp']['preemptions']} times, the "
                             f"bf16 run {paged.preemptions}")
    gate_streams(torch, "slab vs paged (preempting)", cfg32, comp32, prompts,
                 twins["slab"]["streams"], twins["fp"]["streams"])
    stream_readings(torch, "slab vs paged (preempting)", cfg32, comp32, prompts, s_streams,
                    p_streams)
    del comp32
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
    single = {"prompts": prompts, "slab_streams": s_streams,
              "slab_streams32": twins["slab"]["streams"], "fp_streams": p_streams,
              "fp": dict(pages=paged.layout.num_pages, streams=p_streams,
                         streams32=twins["fp"]["streams"], preemptions=paged.preemptions),
              "int8": dict(pages=q_pages, streams=q_streams, preemptions=quant.preemptions)}
    return launches, single


def mesh_streams(recs: list, pool: str, n_prompts: int, gen: int = 32) -> list:
    """The ranks' greedy streams of one run, after checking that every
    request finished its ``gen`` tokens and that every rank holds the same
    streams, host page tables and forward logits."""
    streams = [[rec["results"][u].tokens for u in sorted(rec["results"])] for rec in recs]
    for rec, st in zip(recs, streams):
        bad = [(u, r.finish_reason, len(r.tokens)) for u, r in rec["results"].items()
               if r.finish_reason != "length" or len(r.tokens) != gen]
        if len(st) != n_prompts or bad:
            raise AssertionError(f"{pool}: unfinished requests {bad}")
    for key in ("tables_digest", "logits_digest"):
        if len({rec[key] for rec in recs}) != 1 or any(s != streams[0] for s in streams):
            raise AssertionError(f"{pool}: the ranks disagree on their streams or {key}")
    return streams[0]


# a pool's leaves whose pages axis a rank holds its share of, plus a sink page
POOL_LEAVES = ("k", "v", "ckv", "krope", "k_scale", "v_scale", "ckv_scale", "krope_scale")


class MeshShape:
    """A ``(1, MESH_RANKS)`` mesh as the placement rules read it."""

    axis_names = ("data", "model")

    def __init__(self, model: int):
        import numpy as np

        self.devices = np.empty((1, model), dtype=object)


def mesh_families(torch, cfg, single: dict) -> dict:
    """Phase 8's families: each one's bf16 config (its first layers at full
    width), traffic, engine, runs (pool keywords by name; the f32 twin
    serves the same runs, or those named in ``twins``), K3 form a paged
    decode step takes per attention
    layer (fp, int8), attention layers, K1 launches a prefill forward and
    a decode step (slab, pool), K1b launches a forward, and collectives a
    decode step (slab, pool)."""
    import numpy as np

    from repro_torch.configs import get_config

    def arch(name, n_layers):
        return dataclasses.replace(get_config(name), n_layers=n_layers)

    gpt2 = dataclasses.replace(cfg, n_layers=MESH_LAYERS)
    ds = arch("deepseek-v2-lite-16b", 1 + DS_TWIN_BODY)
    rg = arch("recurrentgemma-9b", 3 * RG_TWIN_BODY)
    mamba = arch("mamba2-2.7b", MESH_LAYERS)
    ds_prompts = [np.random.default_rng(1000 + r).integers(0, ds.vocab, 64).tolist()
                  for r in range(4)]
    rg_prompts = [np.random.default_rng(1000 + r).integers(0, rg.vocab, n).tolist()
                  for r, n in enumerate(RG_PROMPTS)]
    mamba_prompts = [np.random.default_rng(1000 + r).integers(0, mamba.vocab, n).tolist()
                     for r, n in enumerate(MAMBA_PROMPTS)]
    # slab rows the ranks divide, so that the slab splits (else every rank
    # holds it whole, as the sanitized placement does)
    rows = lambda n: -(-n // MESH_RANKS) * MESH_RANKS  # noqa: E731
    pages = lambda n: {"slab": {}, "fp": dict(num_pages=n),  # noqa: E731
                       "int8": dict(num_pages=n, kv_quant=True)}
    # DeepSeek: an MLA layer's prefill runs w_q, w_dkv, w_ukv, w_o through
    # K1 (the absorbed decode step, on either layout over the ranks,
    # decompresses w_ukv instead), the dense first MLP and each MoE layer's
    # shared experts 3, the expert stacks K1b 3 a MoE layer; collectives:
    # MLA 6 a layer, the dense MLP 3, an MoE layer 6, the embedding 1 (the
    # unembedding is dense)
    ds_layers = ds.n_layers
    ds_k1 = 4 * ds_layers + 3 + 3 * (ds_layers - 1)
    ds_coll = 6 * ds_layers + 3 + 6 * (ds_layers - 1) + 1
    return {
        "gpt2-paper": dict(
            cfg=gpt2, prompts=single["prompts"], gen=32, max_len=rows(64 + 32 + 1),
            runs={"slab": {}, "fp": dict(num_pages=single["fp"]["pages"]),
                  "int8": dict(num_pages=single["int8"]["pages"], kv_quant=True)},
            k3=("paged_attn_stats", "paged_attn_stats_q"), attn_layers=gpt2.n_layers,
            k1=(6 * gpt2.n_layers,) * 3, k1b=0, coll=(2 + 8 * gpt2.n_layers,) * 2,
            greedy=True),
        "deepseek-v2-lite-16b": dict(
            cfg=ds, twin_cfg=no_drop(ds), prompts=ds_prompts, gen=MESH_DS_GEN,
            max_len=rows(64 + MESH_DS_GEN + 1), runs=pages(28),
            k3=("paged_attn_mla_stats", "paged_attn_mla_stats_q"), attn_layers=ds_layers,
            k1=(ds_k1, ds_k1 - ds_layers, ds_k1 - ds_layers), k1b=3 * (ds_layers - 1),
            coll=(ds_coll,) * 2, greedy=False),
        "recurrentgemma-9b": dict(  # its 2,100-row prefills dominate: the int8 twin goes
            cfg=rg, prompts=rg_prompts, gen=MESH_GEN, max_len=RG_MAX_LEN, runs=pages(RG_PAGES),
            twins=("slab", "fp"),
            k3=("paged_attn_win_stats", "paged_attn_win_stats_q"), attn_layers=1,
            k1=(2 * 7 + 6,) * 3, k1b=0, coll=(2 * 4 + 8 + 2, 2 * 7 + 8 + 2), greedy=True),
        "mamba2-2.7b": dict(
            cfg=mamba, prompts=mamba_prompts, gen=MESH_GEN,
            max_len=max(MAMBA_PROMPTS) + MESH_GEN + 1, runs={"slab": {}, "pool": dict(num_pages=16)},
            k3=(None, None), attn_layers=0, k1=(2 * MESH_LAYERS,) * 3, k1b=0,
            coll=(2 * MESH_LAYERS + 2,) * 2, greedy=True),
    }


def mesh_launch_gate(name: str, run: str, fam: dict, rec: dict) -> None:
    """A rank's launches in one bf16 run: K3's form of the pool once an
    attention layer and paged decode step, no other attention kernel (no
    K2-family launch on a rank's pool), K1 and K1b at their counts a
    forward (prefill batches and decode steps), and nothing else."""
    st, got = rec["stats"], rec["launches"]
    steps, groups = st["decode_steps"], st["prefill_batches"]
    paged = run != "slab"
    k1_prefill, k1_slab, k1_pool = fam["k1"]
    want = {k: 0 for k in got}
    want["nm_spmm"] = k1_prefill * groups + (k1_pool if paged else k1_slab) * steps
    want["nm_spmm_batched"] = fam["k1b"] * (groups + steps)
    form = fam["k3"][run == "int8"]
    if paged and form:
        want[form] = fam["attn_layers"] * steps
    if got != want:
        raise AssertionError(f"{name} {run}: launches {got}, want {want}")
    coll = fam["coll"][paged]
    if st["collectives_per_decode_step"] != coll:
        raise AssertionError(f"{name} {run}: {st['collectives_per_decode_step']} collectives a "
                             f"decode step, want {coll}")


def mesh_placement_gate(name: str, cfg, comp: dict, recs: list) -> int:
    """Each rank holds every compressed leaf that the placements (the
    reference's, ``serving_param_pspecs``) put on the model axis split on
    that dim, and no such leaf whole; returns the leaves checked."""
    from repro_torch.distributed.compressed_pspecs import serving_param_pspecs
    from repro_torch.sparse_infer import CompressedTensor
    from repro_torch.utils.tree import tree_items

    specs = dict(tree_items(serving_param_pspecs(comp, MeshShape(MESH_RANKS), cfg=cfg)))
    leaves = {n for n, x in tree_items(comp) if isinstance(x, CompressedTensor)}
    for r, rec in enumerate(recs):
        if set(rec["shards"]) != leaves:
            raise AssertionError(f"{name} rank {r}: compressed leaves {sorted(rec['shards'])}")
        for leaf, held in rec["shards"].items():
            values = specs[leaf][0]
            want = (MESH_RANKS if values[-2] == "model" else 1,
                    MESH_RANKS if values[-1] == "model" else 1)
            if tuple(held) != want:
                raise AssertionError(f"{name} rank {r}: {leaf} held {held}, placement {values}")
    return len(leaves)


def mesh_cache_gate(name: str, cache: dict, paged: bool, recs: list) -> int:
    """Every leaf of each rank's cache has the shape that its placement
    (``serving_cache_pspecs``, sanitized for MESH_RANKS ranks) gives the
    single-rank engine's ``cache``: a dim placed on the model axis split
    over the ranks (a pool's pages axis: a rank's share plus its own sink
    page), every other whole.  Returns the leaves held split."""
    from repro_torch.distributed.compressed_pspecs import serving_cache_pspecs
    from repro_torch.distributed.sharding import sanitize_spec
    from repro_torch.utils.tree import tree_items

    layout = type("Layout", (), {"kind": "paged" if paged else "slab"})()
    specs = dict(tree_items(serving_cache_pspecs(MeshShape(MESH_RANKS), cache, layout)))
    split = 0
    for leaf, x in tree_items(cache):
        shape, spec = tuple(x.shape), specs[leaf]
        sink = int(paged and leaf.split("/")[-1] in POOL_LEAVES)
        on = ["model" in (e if isinstance(e, tuple) else (e,)) for e in spec]
        logical = tuple(n - sink if o else n for n, o in zip(shape, on))
        sane = sanitize_spec(spec, logical, MeshShape(MESH_RANKS))
        want = tuple(n // MESH_RANKS + sink if e == "model" else n + (sink if o else 0)
                     for n, e, o in zip(logical, sane, on))
        for r, rec in enumerate(recs):
            if tuple(rec["cache_shapes"][leaf]) != want:
                raise AssertionError(f"{name} rank {r}: cache leaf {leaf} of shape "
                                     f"{rec['cache_shapes'][leaf]}, placement {spec} of "
                                     f"{shape} gives {want}")
        split += want != shape
    for r, rec in enumerate(recs):
        if set(rec["cache_shapes"]) != {leaf for leaf, _ in tree_items(cache)}:
            raise AssertionError(f"{name} rank {r}: cache leaves {sorted(rec['cache_shapes'])}")
    return split


def mesh_phase(torch, cfg, dev, single: dict) -> dict:
    """Phase 8: every family served tensor-parallel by MESH_RANKS ranks on
    the one card (``launch.mesh.run_ranks``: gloo, since the ranks share
    it), all in one spawn (``launch.serve.serve_jobs``: each rank exports
    each family's tree itself, from seed 0, as the main process does):
    gpt2-paper's first MESH_LAYERS layers on phase 3's traffic (slab, fp
    pool, int8 pool), DeepSeek-V2-Lite's first 4 layers (slab, 28-page fp
    and int8 pools), RecurrentGemma-9B's first period (rec, rec, attn) on
    phase 7's prompts past its 2048 window (slab, fp and int8 pools),
    Mamba2-2.7B's first 4 layers (slab, table-less pool), each then as its
    f32 twin (DeepSeek's with an MoE capacity of every token).  Each rank
    holds its slice of every compressed leaf the placements split, its
    rows of every lane of the slab or its page range of the pool.  Gates:
    every request finishes; streams, host page tables and one forward's
    logits are identical on every rank; per rank the exact launches
    (``mesh_launch_gate``) and collectives; no compressed leaf that the
    placements split is whole on a rank, and every cache leaf of a twin
    run has its placement's shape (``mesh_cache_gate``); the ranks' f32
    twins pass the stream gate against the single-rank f32 twin served
    here on the same runs; DeepSeek's f32 forward logits within 1e-4 (atol and rtol) of the
    single rank's.  Returns each kernel's launches summed over the ranks'
    bf16 runs."""
    import numpy as np

    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.serve import export_tree, serve_jobs
    from repro_torch.models.model import forward

    fams = mesh_families(torch, cfg, single)
    jobs = []
    for name, fam in fams.items():
        runs = [dict(run) for run in fam["runs"].values()]
        fam["twins"] = fam.get("twins", tuple(fam["runs"]))
        twin = [dict(fam["runs"][run], logits=name == "deepseek-v2-lite-16b" and run == "slab")
                for run in fam["twins"]]
        if not jobs:  # a warm-up, uncounted
            runs.insert(0, dict(fam["runs"]["fp"], prompts=fam["prompts"][:1],
                                sampling=dict(max_new_tokens=4)))
        jobs.append(dict(cfg=fam["cfg"], twin_cfg=fam.get("twin_cfg", fam["cfg"]), export=True,
                         runs=runs, twin=twin, prompts=fam["prompts"],
                         sampling=dict(max_new_tokens=fam["gen"]),
                         engine_kw=dict(max_batch=4, max_len=fam["max_len"], seed=0,
                                        page_size=16, steps_per_dispatch=4)))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(serve_jobs, (jobs,), model=MESH_RANKS, device=dev.type,
                      log=lambda m: log("  " + m))
    n_runs = sum(len(job["runs"]) + len(job["twin"]) for job in jobs)
    log(f"  {MESH_RANKS} ranks started, exported and served {n_runs} runs of {len(jobs)} archs "
        f"and stopped in {time.perf_counter() - t0:.1f} s")
    totals: dict = {}
    name_card = torch.cuda.get_device_name(0)
    for j, (name, fam) in enumerate(fams.items()):
        t1 = time.perf_counter()
        bf16 = [r[j]["runs"][-len(fam["runs"]):] for r in ranks]
        twin = [r[j]["twin"] for r in ranks]
        export_s = ", ".join(f"{r[j]['export_s']:.1f}" for r in ranks)
        log(f"  {name}: the ranks exported its tree in {export_s} s")
        fcomp = export_tree(fam["cfg"], dev)  # the tree the ranks exported
        checked = mesh_placement_gate(name, fam["cfg"], fcomp, [b[0] for b in bf16])
        for i, run in enumerate(fam["runs"]):
            recs = [b[i] for b in bf16]
            mesh_streams(recs, f"{name} {run}", len(fam["prompts"]), fam["gen"])
            for r, rec in enumerate(recs):
                mesh_launch_gate(f"{name} rank {r}", run, fam, rec)
                for k, v in rec["launches"].items():
                    totals[k] = totals.get(k, 0) + v
            st = recs[0]["stats"]
            log("  serve mesh " + json.dumps({
                "arch": name, "layers": fam["cfg"].n_layers, "run": run, "mesh": st["mesh"],
                "tokens_per_s": st["tokens_per_s"], "ms_per_decode_step": st["ms_per_decode_step"],
                "ms_per_decode_step_host": st["ms_per_decode_step_host"],
                "decode_steps": st["decode_steps"], "prefill_batches": st["prefill_batches"],
                "preemptions": st["preemptions"],
                "collectives_per_decode_step": st["collectives_per_decode_step"],
                "collective_ms_per_decode_step": st["collective_ms_per_decode_step"],
                "kernel_route": recs[0]["kernel_route"], "run_wall_s": recs[0]["wall_s"],
                "launches_per_rank": {k: v for k, v in recs[0]["launches"].items() if v},
                "per_rank_weight_bytes": [rec["stats"]["weight_bytes_per_step"] for rec in recs],
                "per_rank_kv_cache_bytes": [rec["stats"]["kv_cache_bytes"] for rec in recs],
                "device": name_card}))
        # the gate: the single-rank f32 twin on the same runs
        cfg32, comp32 = f32_twin(torch, fam["cfg"], fcomp)
        if "twin_cfg" in fam:
            cfg32 = no_drop(cfg32)
        del fcomp
        torch.cuda.empty_cache()
        for i, run in enumerate(fam["twins"]):
            recs, pool = [t[i] for t in twin], fam["runs"][run]
            streams = mesh_streams(recs, f"{name} f32 {run}", len(fam["prompts"]), fam["gen"])
            eng, _, ref, _ = serve(torch, cfg32, comp32, dev, paged=bool(pool),
                                   num_pages=pool.get("num_pages", 0),
                                   kv_quant=pool.get("kv_quant", False), prompts=fam["prompts"],
                                   gen=fam["gen"], max_len=fam["max_len"])
            if recs[0]["stats"]["preemptions"] != eng.preemptions:
                raise AssertionError(f"{name} f32 {run}: {recs[0]['stats']['preemptions']} "
                                     f"preemptions on the ranks, {eng.preemptions} on one")
            split = mesh_cache_gate(f"{name} f32 {run}", eng.cache, bool(pool), recs)
            log(f"  {name} f32 {run}: every cache leaf of the ranks as placed, {split} split")
            del eng
            log(f"  {name} f32 twin {run} on {MESH_RANKS} ranks: run wall "
                f"{recs[0]['wall_s']:.2f} s, {recs[0]['stats']['ms_per_decode_step']:.1f} ms a "
                f"decode step")
            gate_streams(torch, f"{name} {run}, single rank vs {MESH_RANKS} ranks", cfg32,
                         comp32, fam["prompts"], ref, streams,
                         greedy=fam["greedy"] and run != "int8")
            if recs[0]["logits"] is not None:
                with torch.inference_mode():
                    one, _ = forward(comp32, cfg32, torch.tensor([fam["prompts"][0]], device=dev))
                one = one.float().cpu().numpy()
                for r, rec in enumerate(recs):
                    diff = np.abs(rec["logits"] - one)
                    log(f"  {name} f32 forward logits, rank {r} vs one rank: largest difference "
                        f"{diff.max():.3e} (largest logit {np.abs(one).max():.3f})")
                    if not np.all(diff <= MESH_LOGIT_TOL + MESH_LOGIT_TOL * np.abs(one)):
                        raise AssertionError(f"{name}: rank {r}'s f32 forward logits differ from "
                                             f"one rank's by {diff.max()} (tolerance "
                                             f"{MESH_LOGIT_TOL} atol and rtol)")
        del comp32
        torch.cuda.empty_cache()
        log(f"  {name}: {checked} compressed leaves held as placed; gates in "
            f"{time.perf_counter() - t1:.1f} s")
    return totals


def deepseek_phase(torch, dev, dispatch) -> dict:
    """Phase 6: full-width DeepSeek-V2-Lite's first DS_LAYERS layers,
    exported and compressed leaf by leaf, served on the slab, a pool that never preempts and one that does,
    an int8 pool, and the first pool with chunked prefill and the prefix
    cache; returns the launches of the batched nm_spmm and of paged_attn's
    MLA forms over the first four runs, and under
    ``chunk_dispatch_launches`` each entry's launches measured inside the
    last run's chunk dispatches."""
    import numpy as np

    cfg, comp = arch_tree(torch, dev, "deepseek-v2-lite-16b", DS_LAYERS)
    serve(torch, cfg, comp, dev, paged=True, n_requests=1, gen=4, num_pages=28)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    totals = {"nm_spmm_batched": 0, "paged_attn_mla": 0, "paged_attn_mla_q": 0}
    runs = {}
    # phase 3's traffic, the prompts sharing their first DS_HEAD tokens (the
    # prefix cache's run hits them; the other runs do not care)
    prompts = [np.random.default_rng(1000 + r).integers(0, cfg.vocab, 64).tolist()
               for r in range(8)]
    prompts = [prompts[0][:DS_HEAD] + p[DS_HEAD:] for p in prompts]
    chunked = dict(prefill_chunk=DS_CHUNK, prefix_cache=True)
    for name, pages, kw in (("slab", None, {}), ("paged", 28, {}),
                            ("paged_preempting", 22, {}), ("paged_int8", 28, {}),
                            ("paged_chunk_prefix", 28, chunked)):
        int8 = name == "paged_int8"
        dispatch.reset_launches()
        records: list = []
        eng, _, streams, wall = serve(torch, cfg, comp, dev, paged=pages is not None,
                                      num_pages=pages or 0, kv_quant=int8, prompts=prompts,
                                      chunk_records=records, **kw)
        launches = dict(dispatch.launches)
        steps, groups, chunks = eng.decode_steps, eng.prefill_batches, eng.prefill_chunks
        mla = "paged_attn_mla_q" if int8 else "paged_attn_mla"
        want = {"nm_spmm_batched": 3 * DS_MOE_LAYERS * (steps + groups + chunks),
                "paged_attn_mla": DS_LAYERS * steps if pages and not int8 else 0,
                "paged_attn_mla_q": DS_LAYERS * steps if int8 else 0}
        log(f"  {name}: launches {launches}; {steps} decode steps, {groups} prefill batches, "
            f"{chunks} chunk dispatches: batched nm_spmm wants 3 x {DS_MOE_LAYERS} x ({steps} + "
            f"{groups} + {chunks}) = {want['nm_spmm_batched']}, {mla} {DS_LAYERS} x "
            f"{steps if pages else 0}")
        if any(launches[k] != v for k, v in want.items()) or launches["nm_spmm"] == 0:
            raise AssertionError(f"{name}: launches {launches}, want {want} and nm_spmm > 0")
        if (eng.preemptions > 0) != (name == "paged_preempting"):
            raise AssertionError(f"{name}: {eng.preemptions} preemptions")
        if kw:
            st = eng.stats()
            eng._prefix.clear()
            clear = (eng.pool.free_pages, eng.pool.layout.num_pages, int(eng.pool._ref.sum()))
            log(f"  {name}: " + json.dumps({k: st[k] for k in (
                "prefill_chunks", "prefix_hits", "prefix_hit_tokens", "cow_copies",
                "prefix_evictions", "shared_pages")}) + f"; after clear(): free pages, pages, "
                f"references {clear}")
            if not chunks or not st["prefix_hits"] or clear[0] != clear[1] or clear[2]:
                raise AssertionError(f"{name}: {st}, after clear {clear}")
            chunk_launches = check_chunk_launches(
                f"{name}, each chunk dispatch", records, chunks,
                {"nm_spmm_batched": 3 * DS_MOE_LAYERS, "nm_spmm": None})
        else:
            for k in totals:
                totals[k] += launches[k]
        runs[name] = (eng.stats(), streams, wall)
        del eng
    log("  int8 vs fp pages, 28-page pools (readings): "
        + json.dumps(int8_readings(runs["paged"][1], runs["paged_int8"][1])))
    # the chunk route from one state: f32, the first 4 layers, no MoE drops
    sub_cfg, sub = first_layers(torch, cfg, comp, 3, "float32")
    for paged in (False, True):
        rec = chunk_logit_check(torch, no_drop(sub_cfg), sub, dev, prompts[:4], DS_CHUNK, paged)
        log("  prefill_chunk vs forward, f32, 4 layers, MoE without drops: " + json.dumps(rec))
        if not rec["max_abs_diff"] <= CHUNK_F32_TOL:
            raise AssertionError(f"deepseek prefill_chunk's last logits differ from the "
                                 f"forward's by {rec['max_abs_diff']} > {CHUNK_F32_TOL}")
    del sub
    # the device scheduler, two dispatches a cycle, against a sync run of the
    # same first 4 prompts on the 28-page pool: token for token
    gen4 = (32,) * 4
    sync4 = serve_requests(torch, cfg, comp, dev, prompts[:4], gen4, pages=28)
    dev4 = serve_requests(torch, cfg, comp, dev, prompts[:4], gen4, pages=28,
                          max_steps_per_dispatch=DEV_K, async_stream=True)
    log(f"  device scheduler ({DEV_K} steps, W = 2) vs sync, 4 prompts, 28-page pool: streams "
        f"equal {dev4['streams'] == sync4['streams']}; ms a decode step "
        f"{dev4['stats']['ms_per_decode_step']:.3f} vs {sync4['stats']['ms_per_decode_step']:.3f}"
        f", host share {dev4['stats']['host_overhead_frac']:.4f} vs "
        f"{sync4['stats']['host_overhead_frac']:.4f}; seconds {dev4['wall']:.2f} vs "
        f"{sync4['wall']:.2f}")
    if dev4["streams"] != sync4["streams"] or dev4["reasons"] != sync4["reasons"]:
        raise AssertionError(f"deepseek device scheduler: {dev4['streams']} "
                             f"{dev4['reasons']}, sync {sync4['streams']} {sync4['reasons']}")
    loop_launch_gate("deepseek device W=2", dev4,
                     {"nm_spmm_batched": 3 * DS_MOE_LAYERS, "paged_attn_mla": DS_LAYERS},
                     {"nm_spmm_batched": 3 * DS_MOE_LAYERS})
    del sync4, dev4
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
    peak = torch.cuda.max_memory_allocated()
    for name, (st, _, wall) in runs.items():
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
    # phase 11's tree: the first 4 layers, copied out of the whole tree
    sub_cfg, sub = first_layers(torch, cfg, comp, DS_SPEC_BODY, "bfloat16")
    totals["spec_tree"] = (sub_cfg, clone_tree(sub), prompts[:4])
    del sub
    # the gate: the f32 twin of the first 4 layers (the dense one and 3 MoE
    # layers: the whole 27 layers' twin, about 40 GB, took much of the
    # script's time limit) on the slab and the 28-page pool; the bf16 runs'
    # engines are gone.  The MoE capacity follows a forward's token count,
    # so a forward over a whole stream drops other (token, expert) pairs
    # than the served prefills and steps did: the tokens are held to their
    # first differences only
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg32, comp32 = first_layers(torch, cfg, comp, DS_TWIN_BODY, "float32")
    del comp
    torch.cuda.synchronize()
    log(f"  f32 twin ({cfg32.n_layers} layers): {torch.cuda.memory_allocated():,} B allocated, "
        f"peak {torch.cuda.max_memory_allocated():,} B while it was made")
    twins = twin_runs(torch, cfg32, comp32, dev, {"slab": None, "paged": (28, False)},
                      prompts=prompts)
    gate_streams(torch, "slab vs non-preempting paged", cfg32, comp32, prompts,
                 twins["slab"]["streams"], twins["paged"]["streams"], greedy=False)
    log(f"  slab vs non-preempting paged, bf16 greedy streams at {cfg.n_layers} layers "
        "(reading): " + agree_reading(runs["slab"][1], runs["paged"][1]))
    # chunks and prefix hits against the cold pool: the MoE capacity follows
    # a forward's token count, which chunking changes, so these twins drop
    # no token (no_drop) and differ only by the chunks and the hits
    nd = no_drop(cfg32)
    pair = twin_runs(torch, nd, comp32, dev, {"cold": (28, False)}, prompts=prompts)
    pair |= twin_runs(torch, nd, comp32, dev, {"chunk_prefix": (28, False)}, prompts=prompts,
                      **chunked)
    gate_streams(torch, "chunks and prefix hits vs cold, 28-page pool (twins without MoE "
                 "drops)", nd, comp32, prompts, pair["chunk_prefix"]["streams"],
                 pair["cold"]["streams"], greedy=False)
    log(f"  chunks and prefix hits vs cold, 28-page pool, bf16 greedy streams at "
        f"{cfg.n_layers} layers (reading): " + agree_reading(runs["paged_chunk_prefix"][1], runs["paged"][1]))
    log(f"  peak memory with the f32 twin: {torch.cuda.max_memory_allocated():,} B")
    totals["chunk_dispatch_launches"] = chunk_launches
    return totals


def agree_reading(a: list, b: list) -> str:
    """Two routes' greedy streams as a reading: the tokens equal before
    each request's first difference, over all tokens."""
    from repro_torch.serving.streams import first_difference

    agree = sum(first_difference(x, y) for x, y in zip(a, b))
    return f"{agree}/{sum(len(x) for x in a)} tokens equal before each first difference"


def clone_tree(tree: dict) -> dict:
    """A copy of ``tree`` that shares no storage with it (views of a larger
    tree would keep the whole of it alive)."""
    from repro_torch.sparse_infer import CompressedTensor
    from repro_torch.utils.tree import tree_map_with_name

    return tree_map_with_name(
        lambda _, x: (dataclasses.replace(x, values=x.values.clone(), indices=x.indices.clone())
                      if isinstance(x, CompressedTensor) else x.clone()), tree)


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
    from repro_torch.serving.streams import first_difference

    agree = sum(first_difference(a, b) for a, b in zip(fp_streams, q_streams))
    return {"first_token_equal": [a[0] == b[0] for a, b in zip(fp_streams, q_streams)],
            "greedy_tokens_equal_before_first_difference":
                f"{agree}/{sum(len(a) for a in fp_streams)}"}


def profile_decode(torch, cfg, comp, dev, n_dispatch: int = 2, max_len=97, num_pages=28,
                   prompt_lens=(64, 64, 64, 64), kv_quant=False, gen=32, **sched) -> dict:
    """A ``torch.profiler`` trace of ``n_dispatch`` decode dispatches (K = 4
    steps each; with ``sched``, the device scheduler's arguments, that many
    cycles) with 4 busy lanes on a pool (``kv_quant``: of int8 pages; the
    slab where ``num_pages`` is None) that does not preempt: wall and
    device-busy ms per decode step, the idle share, kernels per step, the
    device ms a step of each of ``paged_attn``'s and ``nm_spmm``'s CUDA
    kernels, the eight kernels with the most device time, and (the launch
    gate's inputs) each of those kernels' launches by name, the wrappers'
    launch counts over the window and how many of its lead records
    kineto dropped (``open_trace``)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import dispatch
    from repro_torch.serving import DecodeEngine, SamplingParams

    eng = DecodeEngine(cfg, comp, max_batch=4, max_len=max_len, seed=0, num_pages=num_pages,
                       page_size=16, steps_per_dispatch=4, kv_quant=kv_quant, device=dev,
                       **sched)
    for r, n in enumerate(prompt_lens):
        eng.submit(np.random.default_rng(2000 + r).integers(0, cfg.vocab, n).tolist(),
                   SamplingParams(max_new_tokens=gen))
    eng.step()  # admission and the first dispatch (or cycle, with its capture), untraced
    torch.cuda.synchronize()
    steps0, launches0 = eng.decode_steps, dict(dispatch.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_trace(torch)
        t0 = time.perf_counter()
        for _ in range(n_dispatch):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = eng.decode_steps - steps0
    kernels, dropped = traced_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # paged_attn's and nm_spmm's CUDA kernels by name (the window form's walk
    # and combine are paged_attn_win_kernel and paged_attn_win_combine; K1's
    # are nm_spmm_decode and, in prefill, nm_spmm_tc)
    by_name = {"paged_attn": {}, "nm_spmm": {}}
    counts = {}
    for e in kernels:
        found = re.search(r"((paged_attn|nm_spmm)\w*)<", e.key)
        if found:
            into = by_name[found[2]]
            into[found[1]] = into.get(found[1], 0.0) + e.self_device_time_total / 1e3 / n
            counts[found[1]] = counts.get(found[1], 0) + e.count
    return {
        "ms_per_decode_step": wall_ms / n,
        "device_busy_ms_per_step": busy_ms / n if busy_ms > 0 else "not measured",
        "idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else "not measured",
        "kernels_per_step": sum(e.count for e in kernels) / n,
        "decode_steps_traced": n,
        **{f"{name}_device_ms_per_step": ms if busy_ms > 0 else "not measured"
           for name, ms in by_name.items()},
        "top_kernels_ms_per_step": {e.key[:70]: e.self_device_time_total / 1e3 / n for e in top},
        "kernel_launches_by_name": counts,
        "lead_records_dropped": dropped,
        "wrapper_launches": {k: v - launches0[k] for k, v in dispatch.launches.items()
                             if v != launches0[k]},
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
    """Phase 7: full-width RecurrentGemma-9B's first RG_LAYERS layers,
    exported and compressed leaf by leaf, served on the slab, a pool that never preempts and one that
    does; returns the launches of K1 and K2w over the three runs."""
    import numpy as np

    cfg, comp = arch_tree(torch, dev, "recurrentgemma-9b", RG_LAYERS)
    kinds = cfg.block_kinds()
    attn_layers = kinds.count("attn")
    k1_pass = RG_K1_REC * (len(kinds) - attn_layers) + RG_K1_ATTN * attn_layers
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
        want = {"nm_spmm": k1_pass * (steps + groups),
                "paged_attn_win": attn_layers * steps if pages and not int8 else 0,
                "paged_attn_win_q": attn_layers * steps if int8 else 0,
                "paged_attn": 0, "paged_attn_mla": 0, "nm_spmm_batched": 0,
                "paged_attn_q": 0, "paged_attn_mla_q": 0}
        log(f"  {name}: launches {launches}; {steps} decode steps, {groups} prefill batches: "
            f"nm_spmm wants {k1_pass} x ({steps} + {groups}) = {want['nm_spmm']}, "
            f"{win} {attn_layers} x {steps if pages else 0}")
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
        st = eng.stats()
        if int8 and st.get("evicted_pages") != runs["paged"][0].get("evicted_pages"):
            raise AssertionError(f"int8 run evicted {st.get('evicted_pages')} pages, the fp "
                                 f"run {runs['paged'][0].get('evicted_pages')}")
        for k in totals:
            totals[k] += launches[k]
        runs[name] = (st, streams, wall)
        del eng
    log("  int8 vs fp pages, 520-page pools (readings): "
        + json.dumps(int8_readings(runs["paged"][1], runs["paged_int8"][1])))
    # the device scheduler, two dispatches a cycle, against the 520-page
    # sync run: its last dispatch ends in gated iterations, which must leave
    # the RG-LRU state as it is
    d = serve_requests(torch, cfg, comp, dev, prompts, (RG_GEN,) * 4, pages=RG_PAGES,
                       max_len=RG_MAX_LEN, max_steps_per_dispatch=RG_DEV_K, async_stream=True)
    st = d["stats"]
    log(f"  device scheduler ({RG_DEV_K} steps, W = 2) vs sync, 520-page pool: streams equal "
        f"{d['streams'] == runs['paged'][1]}; ms a decode step {st['ms_per_decode_step']:.3f} "
        f"vs {runs['paged'][0]['ms_per_decode_step']:.3f}, host share "
        f"{st['host_overhead_frac']:.4f}; {st['gated_iterations']} gated iterations; seconds "
        f"{d['wall']:.2f} vs {runs['paged'][2]:.2f}")
    if d["streams"] != runs["paged"][1] or st["gated_iterations"] == 0:
        raise AssertionError(f"recurrentgemma device scheduler: {d['streams']}, sync "
                             f"{runs['paged'][1]}, {st['gated_iterations']} gated")
    loop_launch_gate("recurrentgemma device W=2", d,
                     {"nm_spmm": k1_pass, "paged_attn_win": attn_layers},
                     {"nm_spmm": k1_pass})
    del d
    # the two decode routes from one state past the window: f32 on the
    # first period and the tail must agree to summation order; bf16 at
    # the phase's depth shows the rounding the streams see
    routes = {}
    for dtype, n_body in (("float32", 1), ("bfloat16", None)):
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
    for name, (st, _, wall) in runs.items():
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
    # the gate: the f32 twin of the first period and the tail (5 layers,
    # one of them windowed attention, as the route check above; the whole
    # depth's twin took about 25 s of the script's time limit) on the slab
    # and the 520-page pool
    cfg32, comp32 = first_layers(torch, cfg, comp, RG_TWIN_BODY, "float32")
    del comp
    torch.cuda.empty_cache()
    twins = twin_runs(torch, cfg32, comp32, dev, {"slab": None, "paged": (RG_PAGES, False)},
                      prompts=prompts, **run)
    gate_streams(torch, f"slab vs non-preempting paged ({cfg32.n_layers} layers)", cfg32,
                 comp32, prompts, twins["slab"]["streams"], twins["paged"]["streams"])
    log(f"  slab vs non-preempting paged, bf16 greedy streams at {cfg.n_layers} layers "
        "(reading): " + agree_reading(runs["slab"][1], runs["paged"][1]))
    return totals


def serve_requests(torch, cfg, comp, dev, prompts, budgets, *, eos=(0, -1), pages=None,
                   int8=False, max_len=None, lanes=4, **sched) -> dict:
    """One greedy run of ``prompts`` with per-request budgets (request
    ``eos[0]`` stops at the id ``eos[1]``) on the slab or a pool of
    ``pages`` (int8 pages with
    ``int8``), by the sync scheduler (K = 4) or, with ``sched``, the device
    scheduler; returns the engine's stats, the streams, the finish reasons,
    the launches counted over the run and the run's seconds."""
    from repro_torch.kernels import dispatch
    from repro_torch.serving import DecodeEngine, SamplingParams

    eng = DecodeEngine(cfg, comp, max_batch=lanes, max_len=max_len or 64 + max(budgets) + 1,
                       seed=0, num_pages=pages, page_size=16, steps_per_dispatch=4,
                       kv_quant=int8, device=dev, **sched)
    uids = [eng.submit(p, SamplingParams(max_new_tokens=n, eos_id=eos[1] if r == eos[0] else -1))
            for r, (p, n) in enumerate(zip(prompts, budgets))]
    dispatch.reset_launches()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(stats=eng.stats(), streams=[res[u].tokens for u in uids],
               reasons=[res[u].finish_reason for u in uids],
               launches={k: v for k, v in dispatch.launches.items() if v}, wall=wall)
    if eng._loop is not None:
        out["captured"] = {str(k): v for k, v in eng._loop.captured.items()}
    del eng
    return out


def loop_launch_gate(what: str, run: dict, per_iteration: dict, per_prefill: dict) -> None:
    """Raise unless each named kernel entry launched ``per_iteration`` times
    for every iteration the device loop ran (replayed, gated ones included,
    and the captures' warm-ups) and ``per_prefill`` times a prefill batch
    or chunk dispatch."""
    st = run["stats"]
    iters = st["loop_iterations"] + st["warmup_iterations"]
    forwards = st["prefill_batches"] + st["prefill_chunks"]
    want = {k: n * iters + per_prefill.get(k, 0) * forwards
            for k, n in per_iteration.items()}
    got = {k: run["launches"].get(k, 0) for k in want}
    log(f"  {what}: launches {got}; {st['loop_iterations']} loop iterations replayed "
        f"({st['decode_steps']} decode steps, {st['gated_iterations']} gated) + "
        f"{st['warmup_iterations']} warm-up, {st['prefill_batches']} prefill batches, "
        f"{st['prefill_chunks']} chunk dispatches: want {want}")
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def device_phase(torch, cfg, comp, dev, single: dict) -> None:
    """Phase 9: full-width gpt2-paper served by the device scheduler
    (``serving/device_loop.py``, replayed as CUDA graphs), held exactly
    against the sync scheduler, then its refills against phase 3's f32
    twins, its launches against the profiler, and readings of both."""
    name = torch.cuda.get_device_name(0)
    prompts = single["prompts"][:4]
    # the exact gate: in each pool an EOS id from its sync run's own stream, a
    # token that a request had not emitted before (past its 4th where one
    # is), so that it fires inside a dispatch (random weights repeat tokens)
    runs = {}
    for pool, pages, int8 in (("slab", None, False), ("fp", EXACT_PAGES, False),
                              ("int8", EXACT_PAGES, True)):
        kw = dict(pages=pages, int8=int8)
        first = serve_requests(torch, cfg, comp, dev, prompts, EXACT_BUDGETS, **kw)["streams"]
        r, j = next((r, j) for lo in (4, 1) for r, st in enumerate(first)
                    for j in range(lo, len(st)) if st[j] not in st[:j])
        kw["eos"] = (r, first[r][j])
        sync = serve_requests(torch, cfg, comp, dev, prompts, EXACT_BUDGETS, **kw)
        log(f"  exact gate, {pool}: budgets {EXACT_BUDGETS}, request {r}'s EOS {first[r][j]} "
            f"(its token {j}); sync finish reasons {sync['reasons']}")
        if sync["reasons"][r] != "eos" or sync["stats"]["preemptions"]:
            raise AssertionError(f"{pool}: sync run {sync['reasons']}, "
                                 f"{sync['stats']['preemptions']} preemptions")
        runs[(pool, "sync")] = sync
        for w in (1, 2):
            d = serve_requests(torch, cfg, comp, dev, prompts, EXACT_BUDGETS, **kw,
                               max_steps_per_dispatch=DEV_K, async_stream=w == 2)
            runs[(pool, f"device W={w}")] = d
            same = d["streams"] == sync["streams"] and d["reasons"] == sync["reasons"]
            log(f"  {pool} W={w}: streams and finish reasons equal to the sync run's: {same}; "
                f"{d['stats']['cycles']} cycles, {d['stats']['dispatches']} dispatches, "
                f"capture {d['stats']['capture_s']:.2f} s, captured {d['captured']}")
            if not same:
                raise AssertionError(f"{pool} W={w}: device {d['streams']} {d['reasons']}, "
                                     f"sync {sync['streams']} {sync['reasons']}")
            per_it = {"nm_spmm": GPT2_K1_PER_LAYER * cfg.n_layers,
                      "paged_attn": cfg.n_layers if pages and not int8 else 0,
                      "paged_attn_q": cfg.n_layers if int8 else 0}
            loop_launch_gate(f"{pool} W={w}", d, per_it,
                             {"nm_spmm": GPT2_K1_PER_LAYER * cfg.n_layers})
    # the refill gate: phase 3's traffic, staged refills, two dispatches a cycle
    refill = dict(max_steps_per_dispatch=DEV_K, staged_lanes=2, async_stream=True)
    gen = (32,) * len(single["prompts"])
    twins = {}
    for pool, pages in (("slab", None), ("fp", single["fp"]["pages"])):
        d = serve_requests(torch, cfg, comp, dev, single["prompts"], gen, pages=pages, **refill)
        st = d["stats"]
        log(f"  refill gate, {pool}: " + json.dumps({k: st[k] for k in (
            "refills", "preemptions", "cycles", "dispatches", "decode_steps", "loop_iterations",
            "gated_iterations", "ms_per_decode_step", "tokens_per_s")}))
        if (st["refills"] == 0 or st["dispatches"] != 2 * st["cycles"]
                or (pages is not None) != (st["preemptions"] > 0)
                or d["reasons"] != ["length"] * len(gen)):
            raise AssertionError(f"refill gate, {pool}: {st} {d['reasons']}")
        runs[(pool, "refill")] = d
    cfg32, comp32 = f32_twin(torch, cfg, comp)
    for pool, pages, sync32 in (("slab", None, single["slab_streams32"]),
                                ("fp", single["fp"]["pages"], single["fp"]["streams32"])):
        d = serve_requests(torch, cfg32, comp32, dev, single["prompts"], gen, pages=pages,
                           **refill)
        gate_streams(torch, f"refill gate, {pool}, device (staged, async) vs sync", cfg32,
                     comp32, single["prompts"], sync32, d["streams"])
        stream_readings(torch, f"refill gate, {pool}, device (staged, async) vs sync (phase 3)",
                        cfg32, comp32, single["prompts"], single[f"{pool}_streams"],
                        runs[(pool, "refill")]["streams"])
    del comp32
    # readings, and the launch gate on the device pool's traced cycles
    reads = {}
    for pool, pages in (("slab", None), ("pool", 36)):
        for sched, kw in (("sync", {}), ("device", dict(max_steps_per_dispatch=DEV_K))):
            reads[(pool, sched)] = profile_decode(torch, cfg, comp, dev, max_len=129,
                                                  num_pages=pages, gen=64, **kw)
            log(f"  profile gpt2 {sched} scheduler, {pool} " + json.dumps(
                {**reads[(pool, sched)], "device": name}))
    rec = reads[("pool", "device")]
    by, wr = rec["kernel_launches_by_name"], rec["wrapper_launches"]
    pairs = {"nm_spmm_decode": wr.get("nm_spmm", 0), "paged_attn_kernel": wr.get("paged_attn", 0)}
    lost = rec["lead_records_dropped"]
    log(f"  launch gate over two traced cycles: profiler {by}, captured x replays {wr} "
        f"(kineto dropped {lost} of the window's {LEAD_KERNELS} lead records)")
    if any(by.get(k, 0) != v or v == 0 for k, v in pairs.items()) or lost == LEAD_KERNELS:
        raise AssertionError(f"launch gate: the profiler counted {by}, the replays {wr}, "
                             f"{lost} of {LEAD_KERNELS} lead records dropped")
    for pool in ("slab", "fp"):
        for sched in ("sync", "device W=1", "device W=2"):
            st = runs[(pool, sched)]["stats"]
            log(f"  serve gpt2 {sched}, {pool} " + json.dumps({
                k: st[k] for k in ("ms_per_decode_step", "tokens_per_s", "host_overhead_frac",
                                   "ms_per_decode_step_host", "decode_steps", "host_syncs")}
                | {"run_wall_s": runs[(pool, sched)]["wall"], "device": name}))


def no_drop(cfg):
    """``cfg`` with an MoE capacity of every routed token (capacity factor
    E / top_k): a forward's token count then drops nothing, so a chunked
    and a monolithic prefill route every token alike."""
    if cfg.moe is None:
        return cfg
    moe = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    return dataclasses.replace(cfg, moe=moe)


def chunk_logit_check(torch, cfg, comp, dev, prompts, csz: int, paged: bool) -> dict:
    """``models.model.prefill_chunk`` chunk by chunk (a row a lane, padded to
    a power of two with the sentinel lane) on the slab or a pool, each
    lane's last chunk's logits against one ``forward`` of its whole prompt:
    the largest difference over the lanes, and the chunk dispatches."""
    import numpy as np

    from repro_torch.models.cache import SlabLayout, cdiv
    from repro_torch.models.model import forward, init_cache, prefill_chunk
    from repro_torch.serving.kv_pool import PagedKVPool

    b, max_len = len(prompts), max(map(len, prompts)) + 1
    if paged:
        pool = PagedKVPool(cfg, max_batch=b, max_len=max_len, page_size=16, device=dev,
                           num_pages=b * cdiv(max_len, 16))
        for i, p in enumerate(prompts):
            assert pool.alloc_prefill(i, len(p))
        pool.device_tables()
        cache, layout = pool.cache, pool.layout
    else:
        cache, layout = init_cache(cfg, b, max_len, device=dev), SlabLayout(max_len)
    pos, last, dispatches = [0] * b, {}, 0
    while any(q < len(p) for q, p in zip(pos, prompts)):
        rows = [i for i, p in enumerate(prompts) if pos[i] < len(p)]
        nb = 1 << (len(rows) - 1).bit_length()
        toks = np.zeros((nb, csz), np.int64)
        lanes = np.full((nb,), b, np.int64)
        starts, lengths = np.zeros((nb,), np.int64), np.zeros((nb,), np.int64)
        for r, i in enumerate(rows):
            part = prompts[i][pos[i]:pos[i] + csz]
            toks[r, :len(part)], lanes[r], starts[r], lengths[r] = part, i, pos[i], len(part)
        rows_t = [torch.from_numpy(x).to(dev) for x in (lanes, starts, lengths)]
        logits, _ = prefill_chunk(comp, cfg, torch.from_numpy(toks).to(dev), cache, *rows_t,
                                  layout)
        dispatches += 1
        for r, i in enumerate(rows):
            pos[i] += int(lengths[r])
            if pos[i] == len(prompts[i]):
                last[i] = logits[r].float()
    worst = 0.0
    for i, p in enumerate(prompts):
        want = forward(comp, cfg, torch.tensor([p], device=dev))[0][0, -1].float()
        worst = max(worst, (last[i] - want).abs().max().item())
    return {"max_abs_diff": worst, "chunk_dispatches": dispatches,
            "layout": "paged" if paged else "slab", "prompts": [len(p) for p in prompts]}


def serve_waves(torch, cfg, comp, dev, waves, *, pages, int8=False, gen=32, max_len,
                **kw) -> dict:
    """Greedy serving of ``waves`` of prompts, each drained before the next
    is submitted (so that a later wave can hit what an earlier one
    cached), over 4 lanes on the slab or a pool of ``pages`` 16-token pages
    (int8 with ``int8``), by the sync scheduler (K = 4) or, with ``kw``'s
    device scheduler arguments, by it; ``kw`` also carries
    ``prefill_chunk`` and ``prefix_cache``.  Every request must run to its
    ``gen`` tokens.  Returns the stats, streams, launches, each chunk
    dispatch's launches (``watch_chunks``) and seconds, and
    where the prefix cache ran, the pool after the index is cleared: free
    pages and the references left."""
    from repro_torch.kernels import dispatch
    from repro_torch.serving import DecodeEngine, SamplingParams

    eng = DecodeEngine(cfg, comp, max_batch=4, max_len=max_len, seed=0, num_pages=pages,
                       page_size=16, steps_per_dispatch=4, kv_quant=int8, device=dev, **kw)
    records = watch_chunks(eng, [])
    dispatch.reset_launches()
    t0 = time.perf_counter()
    streams = []
    for prompts in waves:
        uids = [eng.submit(p, SamplingParams(max_new_tokens=gen)) for p in prompts]
        res = eng.run()
        for u in uids:
            if len(res[u].tokens) != gen or res[u].finish_reason != "length":
                raise AssertionError(f"request {u}: {len(res[u].tokens)} tokens, "
                                     f"{res[u].finish_reason}")
        streams += [res[u].tokens for u in uids]
    torch.cuda.synchronize()
    out = dict(stats=eng.stats(), streams=streams, wall=time.perf_counter() - t0,
               launches={k: v for k, v in dispatch.launches.items() if v},
               chunk_records=records)
    if eng._prefix is not None:
        eng._prefix.clear()
        out["after_clear"] = {"free_pages": eng.pool.free_pages,
                              "num_pages": eng.pool.layout.num_pages,
                              "references": int(eng.pool._ref.sum())}
    del eng
    return out


def sync_launch_gate(what: str, run: dict, per_forward: dict, per_step: dict) -> None:
    """Raise unless each named kernel entry launched ``per_forward`` times a
    forward (decode step, prefill batch or chunk dispatch) plus
    ``per_step`` times a decode step, exactly, over a sync run."""
    st = run["stats"]
    forwards = st["decode_steps"] + st["prefill_batches"] + st["prefill_chunks"]
    want = {k: n * forwards + per_step.get(k, 0) * st["decode_steps"]
            for k, n in per_forward.items()}
    want.update({k: n * st["decode_steps"] for k, n in per_step.items() if k not in want})
    got = {k: run["launches"].get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want} ({st['decode_steps']} "
                             f"decode steps, {st['prefill_batches']} prefill batches, "
                             f"{st['prefill_chunks']} chunk dispatches)")


def profile_chunk(torch, cfg, comp, dev, prompts) -> dict:
    """A ``torch.profiler`` trace of one chunk dispatch of 4 lanes (4 x 64
    rows, the second chunk of four prompts longer than 128) on a pool: its
    wall ms, K1's kernels by name with their launches and device ms, and
    the wrappers' launch counts over the window."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import dispatch
    from repro_torch.serving import DecodeEngine, SamplingParams

    eng = DecodeEngine(cfg, comp, max_batch=4, max_len=max(map(len, prompts)) + 2, seed=0,
                       num_pages=CHUNK_PAGES, page_size=16, prefill_chunk=CHUNK, device=dev)
    for p in prompts:
        eng.submit(p, SamplingParams(max_new_tokens=1))
    out: list = []
    eng._admit(out)
    eng._advance_chunks(out)  # the first chunk, untraced
    torch.cuda.synchronize()
    launches0 = dict(dispatch.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_trace(torch)
        t0 = time.perf_counter()
        eng._advance_chunks(out)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, dropped = traced_kernels(prof)
    k1, k1_ms = {}, 0.0
    for e in kernels:
        found = re.search(r"(nm_spmm\w*)<", e.key)
        if found:
            k1[found[1]] = k1.get(found[1], 0) + e.count
            k1_ms += e.self_device_time_total / 1e3
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"rows": 4 * CHUNK, "wall_ms": wall_ms, "k1_launches_by_name": k1,
            "k1_device_ms": k1_ms if busy_ms > 0 else "not measured",
            "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
            "lead_records_dropped": dropped,
            "wrapper_launches": {k: v - launches0[k] for k, v in dispatch.launches.items()
                                 if v != launches0[k]}}


def prefix_waves(cfg) -> list:
    """Phase 10's prefix traffic: two waves of 4 prompts sharing a
    ``PREFIX_HEAD``-token head, with tails of ``PREFIX_TAILS`` tokens."""
    import numpy as np

    rng = np.random.default_rng(5000)
    head = rng.integers(0, cfg.vocab, PREFIX_HEAD).tolist()
    tails = rng.integers(PREFIX_TAILS[0], PREFIX_TAILS[1] + 1, 8)
    shared = [head + rng.integers(0, cfg.vocab, int(t)).tolist() for t in tails]
    return [shared[:4], shared[4:]]


def chunk_phase(torch, cfg, comp, dev) -> dict:
    """Phase 10: full-width gpt2-paper with chunked prefill and the prefix
    cache (phase 3's compressed tree and its f32 twin).  Returns each
    entry's launches measured inside its bf16 runs' chunk dispatches."""
    import numpy as np

    name = torch.cuda.get_device_name(0)
    gen = 32
    prompts = [np.random.default_rng(4000 + r).integers(0, cfg.vocab, n).tolist()
               for r, n in enumerate(CHUNK_PROMPTS)]
    max_len = max(CHUNK_PROMPTS) + gen + 1
    cfg32, comp32 = f32_twin(torch, cfg, comp)
    # the model-level check: each lane's last chunk against one forward, f32
    for paged in (False, True):
        rec = chunk_logit_check(torch, cfg32, comp32, dev, prompts[:4], CHUNK, paged)
        log("  prefill_chunk vs forward, f32 full depth: " + json.dumps(rec))
        if not rec["max_abs_diff"] <= CHUNK_F32_TOL:
            raise AssertionError(f"prefill_chunk's last logits differ from the forward's by "
                                 f"{rec['max_abs_diff']} > {CHUNK_F32_TOL}: {rec}")
    rec = profile_chunk(torch, cfg, comp, dev, prompts[:4])
    log("  profile of one chunk dispatch (bf16, 4 x 64 rows): "
        + json.dumps({**rec, "device": name}))
    want = GPT2_K1_PER_LAYER * cfg.n_layers
    if (sum(rec["k1_launches_by_name"].values()) != want
            or rec["wrapper_launches"].get("nm_spmm") != want
            or rec["lead_records_dropped"] == LEAD_KERNELS):
        raise AssertionError(f"one chunk dispatch: the profiler counted K1 "
                             f"{rec['k1_launches_by_name']}, the wrapper "
                             f"{rec['wrapper_launches']}; want {want} of each")
    # the chunked traffic on the slab, an fp pool and an int8 pool of no more
    # bytes, each against the same engine without chunking
    fp_bytes = (CHUNK_PAGES + 1) * cfg.n_layers * 16 * 2 * cfg.n_kv * cfg.hd * 2
    q_pages = fp_bytes // (cfg.n_layers * 16 * 2 * (cfg.n_kv * cfg.hd + 2)) - 1
    in_chunks: dict = {}
    for pool, pages, int8 in (("slab", None, False), ("fp", CHUNK_PAGES, False),
                              ("int8", q_pages, True)):
        runs = {}
        for mode, kw in (("chunked", dict(prefill_chunk=CHUNK)), ("monolithic", {})):
            runs[mode] = serve_waves(torch, cfg, comp, dev, [prompts], pages=pages, int8=int8,
                                     max_len=max_len, **kw)
            attn = "paged_attn_q" if int8 else "paged_attn"
            sync_launch_gate(f"{pool} {mode}", runs[mode], {"nm_spmm": want},
                             {attn: cfg.n_layers} if pages else {"paged_attn": 0,
                                                                 "paged_attn_q": 0})
            st = runs[mode]["stats"]
            log(f"  chunked traffic, {pool}, {mode}: " + json.dumps({k: st[k] for k in (
                "prefill_chunks", "prefill_batches", "decode_steps", "preemptions",
                "ms_per_decode_step", "tokens_per_s", "kv_cache_bytes")} | {
                "run_wall_s": runs[mode]["wall"], "nm_spmm_launches":
                runs[mode]["launches"].get("nm_spmm", 0), "device": name}))
        st = runs["chunked"]["stats"]
        if st["prefill_chunks"] == 0 or st["preemptions"] or runs["monolithic"]["stats"][
                "prefill_chunks"]:
            raise AssertionError(f"{pool}: chunked run {st}")
        add_launches(in_chunks, check_chunk_launches(
            f"chunked traffic, {pool}", runs["chunked"]["chunk_records"], st["prefill_chunks"],
            {"nm_spmm": want}))
        stream_readings(torch, f"chunked vs monolithic, {pool}", cfg32, comp32, prompts,
                        runs["chunked"]["streams"], runs["monolithic"]["streams"])
        twins = {mode: serve_waves(torch, cfg32, comp32, dev, [prompts], pages=pages,
                                   int8=int8, max_len=max_len, **kw)["streams"]
                 for mode, kw in (("chunked", dict(prefill_chunk=CHUNK)), ("monolithic", {}))}
        gate_streams(torch, f"chunked vs monolithic, {pool}", cfg32, comp32, prompts,
                     twins["chunked"], twins["monolithic"], greedy=not int8)
    # the prefix cache: two waves of 4 prompts sharing a 136-token head
    waves = prefix_waves(cfg)
    shared = waves[0] + waves[1]
    pmax_len = PREFIX_HEAD + PREFIX_TAILS[1] + gen + 1
    q_pages = ((PREFIX_PAGES + 1) * cfg.n_layers * 16 * 2 * cfg.n_kv * cfg.hd * 2
               // (cfg.n_layers * 16 * 2 * (cfg.n_kv * cfg.hd + 2)) - 1)
    device_kw = dict(prefill_chunk=CHUNK, max_steps_per_dispatch=DEV_K, staged_lanes=2,
                     async_stream=True)
    variants = {("fp", "cold"): (PREFIX_PAGES, False, {}),
                ("fp", "prefix"): (PREFIX_PAGES, False, dict(prefix_cache=True)),
                ("int8", "cold"): (q_pages, True, {}),
                ("int8", "prefix"): (q_pages, True, dict(prefix_cache=True)),
                ("fp", "device"): (PREFIX_PAGES, False, dict(prefix_cache=True, **device_kw))}
    bf16, f32 = {}, {}
    for key, (pages, int8, kw) in variants.items():
        run = serve_waves(torch, cfg, comp, dev, waves, pages=pages, int8=int8,
                          max_len=pmax_len, **kw)
        bf16[key] = run
        st = run["stats"]
        log(f"  prefix traffic, {key[0]} pool, {key[1]}: " + json.dumps({k: st.get(k) for k in (
            "prefix_hits", "prefix_hit_tokens", "cow_copies", "shared_pages", "prefill_chunks",
            "prefill_batches", "decode_steps", "preemptions", "ms_per_decode_step",
            "tokens_per_s")} | {"after_clear": run.get("after_clear"), "run_wall_s": run["wall"],
                                "device": name}))
        if key[1] != "cold":
            clear = run["after_clear"]
            if (st["prefix_hits"] != 4 or st["prefix_hit_tokens"] < 4 * 128
                    or clear["free_pages"] != clear["num_pages"] or clear["references"]):
                raise AssertionError(f"prefix run {key}: {st}, after clear {clear}")
        if key[1] == "device":
            loop_launch_gate("prefix + chunks, device scheduler", run,
                             {"nm_spmm": want, "paged_attn": cfg.n_layers}, {"nm_spmm": want})
        else:
            attn = "paged_attn_q" if int8 else "paged_attn"
            sync_launch_gate(f"prefix traffic {key}", run, {"nm_spmm": want},
                             {attn: cfg.n_layers})
        if st["prefill_chunks"]:
            add_launches(in_chunks, check_chunk_launches(
                f"prefix traffic {key}", run["chunk_records"], st["prefill_chunks"],
                {"nm_spmm": want}))
        f32[key] = serve_waves(torch, cfg32, comp32, dev, waves, pages=pages, int8=int8,
                               max_len=pmax_len, **kw)["streams"]
    for pool in ("fp", "int8"):
        stream_readings(torch, f"prefix hit vs cold, {pool}", cfg32, comp32, shared,
                        bf16[(pool, "prefix")]["streams"], bf16[(pool, "cold")]["streams"])
        gate_streams(torch, f"prefix hit vs cold, {pool}", cfg32, comp32, shared,
                     f32[(pool, "prefix")], f32[(pool, "cold")], greedy=pool == "fp")
    stream_readings(torch, "device (prefix, chunks) vs sync cold, fp", cfg32, comp32, shared,
                    bf16[("fp", "device")]["streams"], bf16[("fp", "cold")]["streams"])
    gate_streams(torch, "device (prefix, chunks) vs sync cold, fp", cfg32, comp32, shared,
                 f32[("fp", "device")], f32[("fp", "cold")])
    del comp32
    return in_chunks


def watch_rounds(torch, eng, records: list, profile: bool = False) -> list:
    """Count the wrappers' launches inside each speculative round's draft
    scan and verify pass: the engine's ``_draft`` and ``_verify`` are
    wrapped to read ``dispatch.launches`` just before and after each call;
    a round appends ``{"steps": drafted steps, "draft": {...}, "verify":
    {...}}`` to ``records``.  With ``profile``, the first verify pass runs
    under ``torch.profiler`` and its record gains ``"verify_kernels"``: K1's
    kernels by name with their launches.  Returns ``records``."""
    from torch.profiler import ProfilerActivity, profile as trace

    from repro_torch.kernels import dispatch

    draft, verify = eng._draft, eng._verify

    def moved(before: dict) -> dict:
        return {k: v - before.get(k, 0) for k, v in dispatch.launches.items()
                if v != before.get(k, 0)}

    def draft_scan(r):
        before = dict(dispatch.launches)
        out = draft(r)
        records.append({"steps": r["steps"], "draft": moved(before)})
        return out

    def verify_pass(r, drafts, dprobs):
        before = dict(dispatch.launches)
        if not (profile and len(records) == 1):
            out = verify(r, drafts, dprobs)
        else:
            torch.cuda.synchronize()
            with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                open_trace(torch)
                out = verify(r, drafts, dprobs)
                torch.cuda.synchronize()
            kernels, dropped = traced_kernels(prof)
            k1 = {}
            for e in kernels:
                found = re.search(r"(nm_spmm\w*)<", e.key)
                if found:
                    k1[found[1]] = k1.get(found[1], 0) + e.count
            records[-1]["verify_kernels"] = k1
            records[-1]["lead_records_dropped"] = dropped
        records[-1]["verify"] = moved(before)
        return out

    eng._draft, eng._verify = draft_scan, verify_pass
    return records


def check_round_launches(what: str, records: list, per_step: dict, per_verify: dict) -> dict:
    """Raise unless every round's draft scan launched exactly ``per_step``'s
    entries times its drafted steps (a value of None: one count per step
    that all rounds share, more than 0) and nothing else, and every verify
    pass exactly ``per_verify``; returns the launches summed over the
    rounds."""
    per_step = dict(per_step)
    for k, n in per_step.items():
        if n is None:
            rec = next((r for r in records if r["steps"]), None)
            per_step[k] = rec["draft"].get(k, 0) // rec["steps"] if rec else 0
            if not per_step[k]:
                raise AssertionError(f"{what}: no {k} launches in a draft scan")
    total, bad = {}, []
    for rec in records:
        want = {k: n * rec["steps"] for k, n in per_step.items() if n * rec["steps"]}
        if rec["draft"] != want or rec["verify"] != per_verify:
            bad.append(rec)
        add_launches(total, rec["draft"])
        add_launches(total, rec["verify"])
    steps = [r["steps"] for r in records]
    log(f"  {what}: {len(records)} rounds, drafted steps {steps}; launches {total}; want "
        f"{per_step} a drafted step and {per_verify} a verify pass")
    if not records or bad:
        raise AssertionError(f"{what}: rounds off {per_step} / {per_verify}: {bad[:3]}")
    return total


def serve_spec(torch, cfg, drafter, verifier, dev, waves, *, gamma=None, pages=None,
               int8=False, gen=32, kv_check=False, sampling=None, profile=False,
               **kw) -> dict:
    """``waves`` of prompts (each drained before the next is submitted) over
    4 lanes on the slab or a pool of ``pages`` 16-token pages (int8 with
    ``int8``): with ``gamma``, ``drafter`` drafting and ``verifier``
    verifying; without, the plain engine serving ``verifier`` (K = 4).
    Every request must end on its ``gen`` tokens.  With ``kv_check``, after
    every round each live lane's committed K/V against a ``verifier``
    forward's (``streams.committed_kv_gaps``: the largest gap and
    magnitude).  A pool must end with every page free and no reference
    (after the prefix index is cleared).  Returns stats, streams, the
    launches of each round (``watch_rounds``), the pages rollbacks dropped
    and seconds."""
    from repro_torch.kernels import dispatch
    from repro_torch.serving import DecodeEngine, SamplingParams
    from repro_torch.serving.streams import committed_kv_gaps

    max_len = max(len(p) for w in waves for p in w) + gen + 1
    spec = dict(spec_gamma=gamma, verify_params=verifier) if gamma else {}
    eng = DecodeEngine(cfg, drafter if gamma else verifier, max_batch=4, max_len=max_len,
                       seed=0, num_pages=pages, page_size=16, steps_per_dispatch=1 if gamma else 4,
                       kv_quant=int8, device=dev, **spec, **kw)
    rounds = watch_rounds(torch, eng, [], profile) if gamma else []
    dropped = [0]
    if eng.pool is not None and gamma:
        rollback = eng.pool.rollback

        def counted(lane, new_len):
            used = eng.pool.used_pages
            rollback(lane, new_len)
            dropped[0] += used - eng.pool.used_pages

        eng.pool.rollback = counted
    sp = SamplingParams(max_new_tokens=gen, **(sampling or {}))
    kv = {"max_abs": 0.0, "max_ref": 0.0, "checks": 0}
    dispatch.reset_launches()
    t0 = time.perf_counter()
    streams = []
    for prompts in waves:
        uids = [eng.submit(p, sp) for p in prompts]
        res = {}
        while eng.queue or any(s is not None for s in eng.slots):
            for r in eng.step():
                res[r.uid] = r
            if kv_check:
                toks = {i: (s.prompt + s.generated)[:s.pos] for i, s in enumerate(eng.slots)
                        if s is not None and not s.pending}
                for rec in committed_kv_gaps(cfg, verifier, eng.cache, eng.layout,
                                             toks).values():
                    kv["max_abs"] = max(kv["max_abs"], rec["max_abs"])
                    kv["max_ref"] = max(kv["max_ref"], rec["max_ref"])
                    kv["checks"] += 1
        for u in uids:
            if len(res[u].tokens) != gen or res[u].finish_reason != "length":
                raise AssertionError(f"request {u}: {len(res[u].tokens)} tokens, "
                                     f"{res[u].finish_reason}")
        streams += [res[u].tokens for u in uids]
    torch.cuda.synchronize()
    out = dict(stats=eng.stats(), streams=streams, wall=time.perf_counter() - t0,
               rounds=rounds, rollback_pages=dropped[0], kv=kv)
    if eng.pool is not None:
        if eng._prefix is not None:
            eng._prefix.clear()
        left = (eng.pool.free_pages, eng.pool.layout.num_pages, int(eng.pool._ref.sum()))
        if left[0] != left[1] or left[2]:
            raise AssertionError(f"pages left after the run: free, pages, references {left}")
    del eng
    return out


def spec_readings(what: str, run: dict, plain: dict) -> None:
    """Log a spec run's acceptance, ms a round and a token beside the plain
    verifier's (ms a token: decode wall over the tokens decode emitted,
    every lane's)."""
    st, pst = run["stats"], plain["stats"]
    log(f"  {what}: " + json.dumps({
        **{k: st[k] for k in ("spec_gamma", "spec_rounds", "acceptance_rate",
                              "accepted_per_verify", "draft_tokens", "accepted_draft_tokens",
                              "prefill_chunks", "preemptions")},
        "rollback_pages": run["rollback_pages"],
        "ms_per_round": st["decode_wall_s"] / st["spec_rounds"] * 1e3,
        "ms_per_emitted_token": st["decode_wall_s"] / st["spec_emitted_tokens"] * 1e3,
        "plain_ms_per_emitted_token": pst["decode_wall_s"] / pst["decode_tokens"] * 1e3,
        "plain_ms_per_decode_step": pst["ms_per_decode_step"],
        "run_wall_s": run["wall"], "plain_run_wall_s": plain["wall"]}))


def spec_phase(torch, cfg, comp, dev, single: dict, ds_spec: tuple) -> dict:
    """Phase 11: self-speculative decoding on full-width gpt2-paper (phase
    3's tree, its masked-dense tree, a seed-1 drafter, a 4:8 verifier) and
    on DeepSeek-V2-Lite's first 4 layers (``ds_spec``: phase 6's).  Returns
    each entry's launches summed over the bf16 runs' rounds, the profiled
    verify pass's K1 kernels and the largest error of K1 at run (c)'s
    verify chunk against its plain version."""
    from repro_torch import core
    from repro_torch.models.model import init_params
    from repro_torch.serving.streams import MARGIN
    from repro_torch.sparse_infer import decompress_params, export_compressed

    k1 = GPT2_K1_PER_LAYER * cfg.n_layers

    def export(seed, n, m):
        recipe = core.make_recipe("step", core.SparsityConfig(default=core.NMSparsity(n, m)))
        return export_compressed(init_params(cfg, seed=seed, device=dev), recipe)[0]

    # the traffic: phase 3's first 4 prompts with 32 tokens each (fewer
    # where the drafts are mostly rejected), phase 10's waves
    traffic = {"phase 3": ([single["prompts"][:4]], 32),
               "phase 3, short": ([single["prompts"][:4]], SPEC_GEN_REJECTED),
               "prefix": (prefix_waves(cfg), 32)}
    prefix = dict(prefill_chunk=CHUNK, prefix_cache=True)
    # name -> (drafter, verifier, gamma, traffic, pages, int8, engine keywords)
    runs = {"a slab": ("comp", "ver", SPEC_GAMMA, "phase 3", None, False, {}),
            "a fp": ("comp", "ver", SPEC_GAMMA, "phase 3", SPEC_PAGES, False, {}),
            "a int8": ("comp", "ver", SPEC_GAMMA, "phase 3", SPEC_PAGES, True, {}),
            "b fp": ("comp1", "ver", SPEC_GAMMA_REJECT, "phase 3, short", SPEC_PAGES, False, {}),
            "c fp": ("comp", "comp48", SPEC_GAMMA, "phase 3, short", SPEC_PAGES, False, {}),
            "d fp": ("comp", "ver", SPEC_GAMMA, "prefix", PREFIX_PAGES, False, prefix)}
    t0 = time.perf_counter()
    trees = {"comp": comp, "ver": decompress_params(comp), "comp1": export(1, 2, 4),
             "comp48": export(0, 4, 8)}
    # run (c)'s verify chunk on K1's tensor-core body at 4:8, against the
    # plain version (no serving run gives it these inputs)
    verify_err = check_nm_spmm_verify(torch, trees["comp48"], dev, 4 * (SPEC_GAMMA + 1))
    twins = {}
    for k in ("comp", "comp1", "comp48"):
        cfg32, twins[k] = f32_twin(torch, cfg, trees[k])
    log(f"  trees, their f32 twins and the 4:8 check: {time.perf_counter() - t0:.1f} s")
    totals: dict = {}
    verify_profile = None
    bf16, plains = {}, {}
    for name, (d, v, gamma, t, pages, int8, kw) in runs.items():
        waves, gen = traffic[t]
        t0 = time.perf_counter()
        run = serve_spec(torch, cfg, trees[d], trees[v], dev, waves, gamma=gamma, pages=pages,
                         int8=int8, gen=gen, profile=name == "c fp", **kw)
        if (v, t, pages, int8) not in plains:
            plains[(v, t, pages, int8)] = serve_spec(torch, cfg, None, trees[v], dev, waves,
                                                     pages=pages, int8=int8, gen=gen)
        bf16[name] = run
        spec_readings(f"{name} (bf16)", run, plains[(v, t, pages, int8)])
        attn = {} if pages is None else {"paged_attn_q" if int8 else "paged_attn": cfg.n_layers}
        add_launches(totals, check_round_launches(
            f"{name}, each round", run["rounds"], {"nm_spmm": k1, **attn},
            {"nm_spmm": k1} if v == "comp48" else {}))
        st = run["stats"]
        if name == "c fp":
            # its first verify pass ran under the profiler (in its wall)
            rec = run["rounds"][0]
            verify_profile = rec["verify_kernels"]
            log(f"  c fp, the profiled verify pass ({4 * (gamma + 1)} rows): K1 kernels "
                f"{verify_profile}, the wrapper's {rec['verify']} (kineto dropped "
                f"{rec['lead_records_dropped']} of {LEAD_KERNELS} lead records)")
            if (verify_profile.get("nm_spmm_tc") != k1 or sum(verify_profile.values()) != k1
                    or rec["lead_records_dropped"] == LEAD_KERNELS):
                raise AssertionError(f"c: the profiled verify pass ran K1 {verify_profile}, "
                                     f"want {k1} nm_spmm_tc")
        if name == "b fp" and not (st["acceptance_rate"] < 1.0 and st["draft_tokens"]
                                   and run["rollback_pages"]):
            raise AssertionError(f"b: the seed-1 drafter's acceptance {st['acceptance_rate']}, "
                                 f"{run['rollback_pages']} pages rolled back")
        if name == "d fp" and (st["prefix_hits"] != 4 or not st["prefill_chunks"]):
            raise AssertionError(f"d: {st['prefix_hits']} prefix hits, {st['prefill_chunks']} "
                                 "chunk dispatches")
        log(f"  {name} (bf16), spec and plain runs: {time.perf_counter() - t0:.1f} s")
    # (e) sampled: every request ends on its budget
    sampled = serve_spec(torch, cfg, comp, trees["ver"], dev, traffic["phase 3"][0],
                         gamma=SPEC_GAMMA, pages=SPEC_PAGES,
                         sampling=dict(temperature=SPEC_TEMPERATURE, top_k=SPEC_TOP_K))
    spec_readings(f"e fp sampled (temperature {SPEC_TEMPERATURE}, top-k {SPEC_TOP_K})", sampled,
                  plains[("ver", "phase 3", SPEC_PAGES, False)])
    add_launches(totals, check_round_launches("e fp sampled, each round", sampled["rounds"],
                                              {"nm_spmm": k1, "paged_attn": cfg.n_layers}, {}))
    # the gate: f32 twins of every tree, spec against the plain f32 verifier,
    # and the committed K/V after every round; the bf16 streams as readings
    del trees
    trees = {**twins, "ver": decompress_params(twins["comp"])}
    del twins
    plains32: dict = {}
    for name, (d, v, gamma, t, pages, int8, kw) in runs.items():
        waves, gen = traffic[t]
        t0 = time.perf_counter()
        run = serve_spec(torch, cfg32, trees[d], trees[v], dev, waves, gamma=gamma, pages=pages,
                         int8=int8, gen=gen, kv_check=True, **kw)
        # the plain f32 verifier on the slab and the fp pool is one function
        # (sums in other orders): the slab's run is gated against the pool's
        key = (v, t, SPEC_PAGES if pages is None else pages, int8)
        if key not in plains32:
            plains32[key] = serve_spec(torch, cfg32, None, trees[v], dev, waves, pages=key[2],
                                       int8=int8, gen=gen)
        prompts = [p for w in waves for p in w]
        stream_readings(torch, f"{name}, spec vs plain verifier", cfg32, trees[v], prompts,
                        bf16[name]["streams"], plains[(v, t, pages, int8)]["streams"])
        gate_streams(torch, f"{name}, spec vs plain verifier", cfg32, trees[v], prompts,
                     run["streams"], plains32[key]["streams"], greedy=not int8)
        kv = run["kv"]
        log(f"  {name}, f32: acceptance {run['stats']['acceptance_rate']:.4f}; committed K/V "
            f"against a verifier forward after every round: largest gap {kv['max_abs']:.3e} "
            f"(entries up to {kv['max_ref']:.3f}), {kv['checks']} lane checks"
            + (" (a reading on int8 pages)" if int8 else f" (limit {SPEC_KV_F32_TOL})"))
        if not kv["checks"] or (not int8 and not kv["max_abs"] <= SPEC_KV_F32_TOL):
            raise AssertionError(f"{name}: committed K/V {kv}")
        log(f"  {name} (f32 twins), the gated runs: {time.perf_counter() - t0:.1f} s")
    del trees
    t0 = time.perf_counter()
    add_launches(totals, spec_deepseek(torch, dev, *ds_spec))
    log(f"  deepseek: {time.perf_counter() - t0:.1f} s")
    log(f"  spec launches over the bf16 rounds {totals}; stream gate margin {MARGIN}")
    return {"launches": totals, "verify_profile": verify_profile, "verify_err": verify_err}


def check_nm_spmm_verify(torch, comp: dict, dev, rows: int) -> float:
    """K1 at a verify chunk of ``rows`` bf16 rows (a partial 64-row tile of
    the tensor-core body) on the six matmuls of ``comp``'s first layer,
    against the plain version within one bf16 step; two calls give the same
    bytes.  Returns the largest error."""
    from repro_torch.kernels.nm_spmm import nm_spmm, nm_spmm_plain

    gen = torch.Generator(device=dev).manual_seed(7)
    err = 0.0
    for name, w in layer_leaves(comp).items():
        k_dim = w.values.shape[0] * w.m // w.n
        x = torch.randn((rows, k_dim), generator=gen, device=dev).to(torch.bfloat16)
        args = (x, w.values, w.indices, w.n, w.m, w.out_features)
        label = f"nm_spmm {name} {w.n}:{w.m} B={rows} ({k_dim}->{w.out_features})"
        y = nm_spmm(*args)
        same_bytes(torch, label, y, nm_spmm(*args))
        err = max(err, check_close(label, y, nm_spmm_plain(*args)))
    return err


def spec_deepseek(torch, dev, cfg, comp, prompts) -> dict:
    """Phase 11's DeepSeek part: its first 4 layers (the compressed tree
    drafting, its masked-dense tree verifying) on the 28-page pool, gamma
    ``DS_SPEC_GAMMA``, against the plain verifier; then the no-drop f32
    twins through the stream gate and the committed-K/V check.  Returns the
    launches summed over the bf16 rounds."""
    from repro_torch.sparse_infer import decompress_params

    ver = decompress_params(comp)
    run = serve_spec(torch, cfg, comp, ver, dev, [prompts], gamma=DS_SPEC_GAMMA,
                     pages=SPEC_PAGES)
    plain = serve_spec(torch, cfg, None, ver, dev, [prompts], pages=SPEC_PAGES)
    del ver
    spec_readings(f"deepseek {cfg.n_layers} layers fp (bf16)", run, plain)
    totals = check_round_launches(
        "deepseek, each round", run["rounds"],
        {"nm_spmm_batched": 3 * DS_SPEC_BODY, "paged_attn_mla": cfg.n_layers, "nm_spmm": None},
        {})
    # the gate: no-drop f32 twins (a verify chunk of 4 x 4 tokens meets
    # other MoE capacities than a decode step's 4)
    cfg32, comp32 = f32_twin(torch, cfg, comp)
    nd, ver32 = no_drop(cfg32), decompress_params(comp32)
    run32 = serve_spec(torch, nd, comp32, ver32, dev, [prompts], gamma=DS_SPEC_GAMMA,
                       pages=SPEC_PAGES, kv_check=True)
    plain32 = serve_spec(torch, nd, None, ver32, dev, [prompts], pages=SPEC_PAGES)
    stream_readings(torch, "deepseek, spec vs plain verifier", nd, ver32, prompts,
                    run["streams"], plain["streams"])
    gate_streams(torch, "deepseek, spec vs plain verifier (twins without MoE drops)", nd, ver32,
                 prompts, run32["streams"], plain32["streams"], greedy=False)
    kv = run32["kv"]
    log(f"  deepseek, f32: acceptance {run32['stats']['acceptance_rate']:.4f}; committed K/V "
        f"against a verifier forward after every round: largest gap {kv['max_abs']:.3e} "
        f"(entries up to {kv['max_ref']:.3f}), {kv['checks']} lane checks (limit "
        f"{SPEC_KV_F32_TOL})")
    if not kv["checks"] or not kv["max_abs"] <= SPEC_KV_F32_TOL:
        raise AssertionError(f"deepseek: committed K/V {kv}")
    return totals


def k1_bodies(cfg, comp, rows: dict) -> dict:
    """Which K1 body each compressed matmul of the first layer takes at each
    of ``rows`` (label -> (B, element bytes)), from ``launch_plan``: the
    decode kernel (4 or 1 columns a lane), the tensor-core body's tile, or
    the first version's body (f32 past 8 rows, or a decode x past the
    96 KB staging budget)."""
    from repro_torch.kernels.nm_spmm import FIRST_BODY, launch_plan
    from repro_torch.sparse_infer import CompressedTensor
    from repro_torch.utils.tree import tree_items

    out = {}
    for name, w in tree_items(comp):
        if not (isinstance(w, CompressedTensor) and name.startswith("body/sb_0/")):
            continue
        w = w.layer(0)
        k, o = w.values.shape[0] * w.m // w.n, w.values.shape[1]
        bodies = {}
        for label, (b, size) in rows.items():
            cols, plan = launch_plan(b, k, o, w.out_features, 1, w.n, w.m, size, True)
            bodies[label] = (f"decode, {cols} columns a lane" if b <= 8 and cols else
                             f"tensor-core {plan.rows}x{plan.cols}" if plan != FIRST_BODY
                             else "first version")
        out[f"{name.split('/')[-1]} ({k}->{w.out_features})"] = bodies
    return out


def k1_leaf(comp: dict, name: str):
    """A compressed 2-D weight: ``frontend/frontend_proj``, or a leaf of the
    first layer named under it (``mlp/w_fc``)."""
    node = comp if name.startswith("frontend/") else comp["body"]["sb_0"]
    for key in name.split("/"):
        node = node[key]
    return node if node.values.dim() == 2 else node.layer(0)


def check_k1_widths(torch, comp, dev, leaves: dict) -> float:
    """K1 on compressed ``leaves`` (``k1_leaf`` name -> row counts) against
    its plain version: bf16 x within one bf16 step, f32 x (rows given as
    ``-b``) within 1e-4·|ref| + 1e-5, each call twice (the same bytes).
    Returns the largest error."""
    from repro_torch.kernels.nm_spmm import nm_spmm, nm_spmm_plain

    gen = torch.Generator(device=dev).manual_seed(12)
    err = 0.0
    for name, rows in leaves.items():
        leaf = name.rsplit("/", 1)[-1]
        w = k1_leaf(comp, name)
        k_dim = w.values.shape[0] * w.m // w.n
        for b in rows:
            f32 = b < 0
            x = torch.randn((abs(b), k_dim), generator=gen, device=dev)
            x = x * 0.1 if f32 else x.to(torch.bfloat16)
            vals = w.values.float() if f32 else w.values
            args = (x, vals, w.indices, w.n, w.m, w.out_features)
            label = (f"nm_spmm {leaf} {'f32' if f32 else 'bf16'} B={abs(b)} "
                     f"({k_dim}->{w.out_features}, {w.n}:{w.m})")
            y = nm_spmm(*args)
            same_bytes(torch, label, y, nm_spmm(*args))
            err = max(err, check_close(label, y, nm_spmm_plain(*args),
                                       rtol=F32_RTOL if f32 else BF16_RTOL))
    return err


def arch_tree(torch, dev, name: str, n_layers=None):
    """``(cfg, compressed tree)`` of an arch at full width (its first
    ``n_layers`` where given): random weights from seed 0, the STEP 2:4
    export and compression leaf by leaf."""
    from repro_torch import core
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.sparse_infer import export_compressed

    cfg = get_config(name)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
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
    log(f"  {name}: {cfg.n_layers} layers, {n_params:,} parameters: init {t1 - t0:.1f} s, "
        f"export + compress leaf by leaf {time.perf_counter() - t1:.1f} s, {json.dumps(rep)}; "
        f"peak memory {torch.cuda.max_memory_allocated():,} B, compressed tree "
        f"{torch.cuda.memory_allocated():,} B")
    return cfg, comp


def k1_per_layer(cfg) -> int:
    """K1 launches a layer and forward of a dense attention arch: q/k/v/o
    and the MLP's matmuls (three for SwiGLU, two for GeLU)."""
    return 4 + (3 if cfg.mlp == "swiglu" else 2)


def attn_arch_phase(torch, dev, dispatch, name: str, pools: tuple, n_layers=None,
                    k1_rows=None, extra=None) -> tuple[dict, float]:
    """Phase 12's and 13's dense GQA archs: phase 3's traffic (8 requests of
    64 + 32 tokens over 4 lanes, K = 4) on each of ``pools`` (``slab``,
    ``fp``, ``int8``: 28-page pools that never preempt), with exact launch
    counts (K1 ``k1_per_layer`` a layer per forward, K2 or K2q once a layer
    a paged decode step, nothing else); K1 at ``k1_rows`` of the first
    layer's leaves against its plain version; ``extra(cfg, comp)`` on the
    bf16 tree (its launches counted apart); then the stream gate on the f32
    twins of the slab and the fp pool.  Returns the launches summed over
    the bf16 runs and K1's largest error."""
    cfg, comp = arch_tree(torch, dev, name, n_layers)
    per = k1_per_layer(cfg)
    log(f"  {name}: K1 bodies " + json.dumps(k1_bodies(cfg, comp, {
        "bf16 B=4": (4, 2), "bf16 B=8": (8, 2), "f32 B=4": (4, 4), "bf16 B=256": (256, 2),
        "f32 B=256": (256, 4)})))
    err = check_k1_widths(torch, comp, dev, k1_rows) if k1_rows else 0.0
    if extra is not None:
        err = max(err, extra(cfg, comp))
    serve(torch, cfg, comp, dev, paged=True, n_requests=1, gen=4, num_pages=ARCH_PAGES)
    torch.cuda.reset_peak_memory_stats()
    totals, runs, prompts = {"nm_spmm": 0, "paged_attn": 0, "paged_attn_q": 0}, {}, None
    for pool in pools:
        pages, int8 = {"slab": (None, False), "fp": (ARCH_PAGES, False),
                       "int8": (ARCH_PAGES, True)}[pool]
        dispatch.reset_launches()
        eng, prompts, streams, wall = serve(torch, cfg, comp, dev, paged=pages is not None,
                                            num_pages=pages or 0, kv_quant=int8)
        launches = dict(dispatch.launches)
        steps, groups = eng.decode_steps, eng.prefill_batches
        want = {k: 0 for k in launches}
        want["nm_spmm"] = per * cfg.n_layers * (steps + groups)
        if pages:
            want["paged_attn_q" if int8 else "paged_attn"] = cfg.n_layers * steps
        log(f"  {name} {pool}: launches {({k: v for k, v in launches.items() if v})}; "
            f"{steps} decode steps, {groups} prefill batches: want nm_spmm "
            f"{per * cfg.n_layers} x ({steps} + {groups}), "
            f"{'paged_attn_q' if int8 else 'paged_attn'} {cfg.n_layers if pages else 0} x {steps}")
        if launches != want or eng.preemptions:
            raise AssertionError(f"{name} {pool}: launches {launches}, want {want}; "
                                 f"{eng.preemptions} preemptions")
        for k in totals:
            totals[k] += launches[k]
        runs[pool] = (eng.stats(), streams, wall)
        del eng
    peak = torch.cuda.max_memory_allocated()
    for pool, (st, _, wall) in runs.items():
        log(f"  serve {name} " + json.dumps({
            "run": pool, "tokens_per_s": st["tokens_per_s"],
            "ms_per_decode_step": st["ms_per_decode_step"],
            "ms_per_decode_step_host": st["ms_per_decode_step_host"],
            "decode_steps": st["decode_steps"], "prefill_batches": st["prefill_batches"],
            "run_wall_s": wall, "kv_cache_bytes": st["kv_cache_bytes"],
            "weight_bytes_per_step": st["weight_bytes_per_step"],
            "weight_stream_bound_ms": st["weight_bytes_per_step"] / HBM_BYTES_PER_S * 1e3,
            "peak_memory_bytes": peak, "device": torch.cuda.get_device_name(0)}))
    if "int8" in runs:
        log(f"  {name} int8 vs fp pages (readings): "
            + json.dumps(int8_readings(runs["fp"][1], runs["int8"][1])))
    cfg32, comp32 = f32_twin(torch, cfg, comp)
    del comp
    torch.cuda.empty_cache()
    twins = twin_runs(torch, cfg32, comp32, dev, {"slab": None, "fp": (ARCH_PAGES, False)},
                      prompts=prompts)
    gate_streams(torch, f"{name} slab vs fp pool", cfg32, comp32, prompts,
                 twins["slab"]["streams"], twins["fp"]["streams"])
    if "slab" in runs:
        stream_readings(torch, f"{name} slab vs fp pool", cfg32, comp32, prompts,
                        runs["slab"][1], runs["fp"][1])
    return totals, err


def ssm_route_difference(torch, cfg, comp, prompt, dev, steps: int = 8) -> dict:
    """The SSM decode route from a prefilled state: ``prompt`` prefilled
    (SSD, chunked), then ``steps`` greedy decode steps (the recurrence);
    every step's logits against one forward over the prompt and the tokens
    (SSD over the whole): the largest difference beside the logits'
    spread."""
    from repro_torch.models.model import decode_step, forward, prefill

    toks = torch.tensor([prompt], device=dev)
    logits, cache = prefill(comp, cfg, toks, len(prompt) + steps + 1)
    outs, seq = [logits], list(prompt)
    for _ in range(steps):
        tok = outs[-1].argmax(-1)
        seq.append(int(tok))
        outs.append(decode_step(comp, cfg, tok.int(), cache)[0])
    ref = forward(comp, cfg, torch.tensor([seq], device=dev))[0][0, len(prompt) - 1:].float()
    got = torch.cat(outs).float()
    return {"max_abs_diff": (got - ref).abs().max().item(), "logit_std": ref.std().item(),
            "positions": steps + 1, "same_argmax": bool((got.argmax(-1) == ref.argmax(-1)).all())}


def mamba_phase(torch, dev, dispatch) -> tuple[dict, float]:
    """Phase 12's mamba2-2.7b at full width (its first MAMBA_LAYERS of 64
    layers): 4 requests of 200,
    128, 100 and 64 prompt tokens + 32, prefilled at exact lengths (one SSD
    chunk each), over 4 lanes on the slab and on the table-less paged pool,
    then by the device scheduler over 3 lanes (16 steps a dispatch, the
    fourth request staged: it refills a lane inside the loop); K1 exactly
    128 a forward (``w_in`` and ``w_out`` of each layer), no attention
    kernel.  K1 at ``w_in``'s 10,576 columns and ``w_out`` against its
    plain version.  In f32 the decode route from a prefilled state against
    one forward within 1e-3; the stream gate on the f32 twins of the slab
    and the device run.  Returns the launches and K1's largest error."""
    import numpy as np

    from repro_torch.models.model import forward

    cfg, comp = arch_tree(torch, dev, "mamba2-2.7b", MAMBA_LAYERS)
    log("  mamba2-2.7b: K1 bodies " + json.dumps(k1_bodies(cfg, comp, {
        "bf16 B=4": (4, 2), "f32 B=4": (4, 4), "bf16 B=200": (200, 2),
        "f32 B=200": (200, 4)})))
    err = check_k1_widths(torch, comp, dev, {"mixer/w_in": (4, 200, -4, -200),
                                             "mixer/w_out": (4, 200)})
    prompts = [np.random.default_rng(5000 + r).integers(0, cfg.vocab, n).tolist()
               for r, n in enumerate(MAMBA_PROMPTS)]
    max_len = max(MAMBA_PROMPTS) + MAMBA_GEN + 1
    budgets = (MAMBA_GEN,) * len(prompts)
    run = dict(lanes=4, gen=MAMBA_GEN, k=4, max_len=max_len, prompts=prompts)
    serve(torch, cfg, comp, dev, paged=False, prompts=[prompts[3][:32]], gen=4,
          max_len=max_len)  # warm-up, uncounted
    secs = {}
    for n, p in zip(MAMBA_PROMPTS, prompts):  # one forward a prompt: SSD's seconds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(comp, cfg, torch.tensor([p], device=dev), want_cache=True)
        torch.cuda.synchronize()
        secs[n] = round(time.perf_counter() - t0, 4)
    log(f"  mamba2-2.7b prefill seconds by prompt length (one forward each, bf16): {secs}")
    torch.cuda.reset_peak_memory_stats()
    per = MAMBA_K1_PER_LAYER * cfg.n_layers
    totals, runs = {"nm_spmm": 0}, {}
    for pool in ("slab", "pool"):
        dispatch.reset_launches()
        eng, _, streams, wall = serve(torch, cfg, comp, dev, paged=pool == "pool",
                                      num_pages=4, **run)
        launches = dict(dispatch.launches)
        steps, groups = eng.decode_steps, eng.prefill_batches
        want = {k: 0 for k in launches}
        want["nm_spmm"] = per * (steps + groups)
        log(f"  mamba2-2.7b {pool}: launches {({k: v for k, v in launches.items() if v})}; "
            f"{steps} decode steps, {groups} prefill batches: want nm_spmm {per} x ({steps} + "
            f"{groups}) and no attention kernel")
        if launches != want or groups != len(prompts):
            raise AssertionError(f"mamba2 {pool}: launches {launches}, want {want}, "
                                 f"{groups} prefill batches")
        if pool == "pool" and (eng.cache["tables"] or eng.pool.used_pages
                               or eng.kernel_route() != "none"):
            raise AssertionError(f"mamba2 pool: tables {eng.cache['tables']}, "
                                 f"{eng.pool.used_pages} pages used, {eng.kernel_route()}")
        totals["nm_spmm"] += launches["nm_spmm"]
        runs[pool] = (eng.stats(), streams, wall)
        del eng
    peak = torch.cuda.max_memory_allocated()
    d = serve_requests(torch, cfg, comp, dev, prompts, budgets, pages=4, max_len=max_len,
                       lanes=MAMBA_DEV_LANES, max_steps_per_dispatch=DEV_K, staged_lanes=1)
    st = d["stats"]
    log(f"  mamba2-2.7b device scheduler ({DEV_K} steps, {MAMBA_DEV_LANES} lanes, 1 staged): "
        + json.dumps({k: st[k] for k in ("refills", "cycles", "dispatches", "decode_steps",
                                         "loop_iterations", "gated_iterations",
                                         "ms_per_decode_step", "host_overhead_frac")})
        + f"; finish reasons {d['reasons']}; seconds {d['wall']:.2f}")
    if st["refills"] < 1 or d["reasons"] != ["length"] * len(prompts):
        raise AssertionError(f"mamba2 device scheduler: {st['refills']} refills, "
                             f"{d['reasons']}")
    if set(d["launches"]) != {"nm_spmm"}:
        raise AssertionError(f"mamba2 device scheduler launched {d['launches']}")
    loop_launch_gate("mamba2 device", d, {"nm_spmm": per}, {"nm_spmm": per})
    totals["nm_spmm"] += d["launches"]["nm_spmm"]
    name = torch.cuda.get_device_name(0)
    for pool, (st, _, wall) in runs.items():
        log("  serve mamba2-2.7b " + json.dumps({
            "run": pool, "tokens_per_s": st["tokens_per_s"],
            "ms_per_decode_step": st["ms_per_decode_step"],
            "ms_per_decode_step_host": st["ms_per_decode_step_host"],
            "decode_steps": st["decode_steps"], "prefill_batches": st["prefill_batches"],
            "run_wall_s": wall, "state_bytes_per_lane": st["kv_cache_bytes"] // 4,
            "weight_bytes_per_step": st["weight_bytes_per_step"],
            "weight_stream_bound_ms": st["weight_bytes_per_step"] / HBM_BYTES_PER_S * 1e3,
            "peak_memory_bytes": peak, "device": name}))
    cfg32, comp32 = f32_twin(torch, cfg, comp)
    del comp
    torch.cuda.empty_cache()
    route = ssm_route_difference(torch, cfg32, comp32, prompts[2], dev)
    log("  mamba2-2.7b f32: prefill + 8 decode steps vs one forward: " + json.dumps(route))
    if not route["max_abs_diff"] <= MAMBA_ROUTE_F32_TOL:
        raise AssertionError(f"mamba2: the f32 decode route differs from a forward by "
                             f"{route['max_abs_diff']} > {MAMBA_ROUTE_F32_TOL}")
    slab32 = serve(torch, cfg32, comp32, dev, paged=False, **run)[2]
    dev32 = serve_requests(torch, cfg32, comp32, dev, prompts, budgets, pages=4,
                           max_len=max_len, lanes=MAMBA_DEV_LANES,
                           max_steps_per_dispatch=DEV_K, staged_lanes=1)
    if dev32["stats"]["refills"] < 1:
        raise AssertionError(f"mamba2 f32 device run: {dev32['stats']['refills']} refills")
    gate_streams(torch, "mamba2-2.7b slab vs device scheduler (refill)", cfg32, comp32,
                 prompts, slab32, dev32["streams"])
    stream_readings(torch, "mamba2-2.7b slab vs device scheduler (refill)", cfg32, comp32,
                    prompts, runs["slab"][1], d["streams"])
    return totals, err


def archs_phase(torch, dev, dispatch) -> dict:
    """Phase 12, at full width: starcoder2-3b's first ARCH_LAYERS layers
    (slab, fp and int8 pools), minitron-4b's first 4 (fp pool) and
    mamba2-2.7b's first MAMBA_LAYERS.  Returns the
    launches of K1, K2 and K2q summed over the bf16 runs, each part's
    seconds and K1's largest error at the new widths."""
    out = {"nm_spmm": 0, "paged_attn": 0, "paged_attn_q": 0}
    seconds, err = {}, 0.0
    parts = (("starcoder2-3b", lambda: attn_arch_phase(
                 torch, dev, dispatch, "starcoder2-3b", ("slab", "fp", "int8"), ARCH_LAYERS,
                 k1_rows={"mlp/w_proj": (4, 8, -4, 256), "mlp/w_fc": (4, 256)})),
             ("minitron-4b", lambda: attn_arch_phase(
                 torch, dev, dispatch, "minitron-4b", ("fp",), n_layers=MT_LAYERS)),
             ("mamba2-2.7b", lambda: mamba_phase(torch, dev, dispatch)))
    for name, part in parts:
        t0 = time.perf_counter()
        launches, e = part()
        err = max(err, e)
        for k, v in launches.items():
            out[k] += v
        seconds[name] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
        log(f"  {name}: {seconds[name]} s, launches {launches}")
    return {"launches": out, "seconds": seconds, "k1_err": err}


def frontend_check(torch, dispatch, cfg, comp, dev) -> tuple[float, dict]:
    """Phase 13's stub frontend on one arch's bf16 compressed tree: K1 at
    ``frontend_proj`` (K 1176 with its 24-column tail, or 512) against its
    plain version at 9, 256 and 200 bf16 rows and 4 f32 rows, timed at 256
    rows beside ``torch.matmul`` on the decompressed weight and its bound;
    a forward over stub embeddings (2 x 128 rows, bf16) through the
    compressed tree with exactly 1 + ``k1_per_layer`` x layers K1 launches
    and nothing else, finite logits, against the masked-dense tree's (a
    reading); then the f32 twins of the first 4 layers, compressed against
    masked-dense, within the f32 route limit.  Returns K1's largest error
    and its timing record."""
    from repro_torch.kernels.nm_spmm import nm_spmm, nm_spmm_plain
    from repro_torch.models.model import forward, frontend_dim
    from repro_torch.sparse_infer import decompress_params

    err = check_k1_widths(torch, comp, dev, {"frontend/frontend_proj": (9, 256, 200, -4)})
    w = comp["frontend"]["frontend_proj"]
    k_dim = w.values.shape[0] * w.m // w.n
    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((256, k_dim), generator=gen, device=dev).to(torch.bfloat16)
    args = (x, w.values, w.indices, w.n, w.m, w.out_features)
    dense_w = w.dense().contiguous()
    rec = dict(ms=time_ms(torch, lambda: nm_spmm(*args)),
               plain_ms=time_ms(torch, lambda: nm_spmm_plain(*args)),
               library_ms=time_ms(torch, lambda: torch.matmul(x, dense_w)))
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        x.numel() * 2 + w.values.numel() * 2 + w.indices.numel() + 256 * w.out_features * 2,
        2.0 * 256 * w.values.shape[0] * w.out_features)
    rec["at"] = f"x (256, {k_dim}) bf16 @ frontend_proj {k_dim}->{w.out_features}, 2:4"
    log(f"  time nm_spmm frontend_proj B=256 ({k_dim}->{w.out_features}): kernel "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, torch.matmul(dense) "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    del dense_w
    embeds = torch.randn(FRONT_ROWS + (frontend_dim(cfg),), generator=gen, device=dev)
    dispatch.reset_launches()
    with torch.no_grad():
        logits = forward(comp, cfg, {"embeds": embeds.to(torch.bfloat16)})[0].float()
    torch.cuda.synchronize()
    launches = {k: v for k, v in dispatch.launches.items() if v}
    want = {"nm_spmm": 1 + k1_per_layer(cfg) * cfg.n_layers}
    log(f"  {cfg.name} forward over embeds {tuple(embeds.shape)}: launches {launches}, "
        f"want {want}")
    if launches != want:
        raise AssertionError(f"{cfg.name} embeds forward: launches {launches}, want {want}")
    if tuple(logits.shape) != FRONT_ROWS + (cfg.vocab,) or not bool(logits.isfinite().all()):
        raise AssertionError(f"{cfg.name} embeds forward: logits {tuple(logits.shape)}, "
                             f"finite {bool(logits.isfinite().all())}")
    dense = decompress_params(comp)
    with torch.no_grad():
        ref = forward(dense, cfg, {"embeds": embeds.to(torch.bfloat16)})[0].float()
    del dense
    log(f"  {cfg.name} bf16 forward over embeds, compressed vs masked-dense (reading): max "
        f"|diff| {(logits - ref).abs().max().item():.4f}, logit std {ref.std().item():.4f}, "
        f"argmax equal {(logits.argmax(-1) == ref.argmax(-1)).float().mean().item():.4f}")
    del logits, ref
    cfg32, comp32 = first_layers(torch, cfg, comp, FRONT_TWIN_BODY, "float32")
    dense32 = decompress_params(comp32)
    with torch.no_grad():
        a = forward(comp32, cfg32, {"embeds": embeds})[0]
        b = forward(dense32, cfg32, {"embeds": embeds})[0]
    diff = (a - b).abs().max().item()
    log(f"  {cfg.name} f32 twins of the first {FRONT_TWIN_BODY} layers, embeds forward, "
        f"compressed vs masked-dense: max |diff| {diff:.3e} (limit {DS_ROUTE_F32_TOL})")
    if not diff <= DS_ROUTE_F32_TOL:
        raise AssertionError(f"{cfg.name}: f32 embeds forward differs by {diff}")
    del comp32, dense32, a, b
    torch.cuda.empty_cache()
    return err, rec


def domino_phase(torch, dev, dispatch) -> dict:
    """Phase 13's DominoSearch on qwen2-vl-2b's full-width tree (seed 0):
    ``domino_search(m=8, target_density=0.5)`` on the card, timed; the
    kept share at most the target; the export and compression at each
    leaf's n:8 (K4 once a maskable leaf slice), every compressed leaf at
    its assigned n; K1 at the first layer's n:8 leaves against its plain
    version (4 and 64 bf16 rows), and K4 at each assigned n against its
    plain version, bit for bit.  Then 4 prompts of 64 + 16 tokens on the
    slab (K1 exactly ``k1_per_layer`` a layer and forward), and the f32
    twins: a forward of the prompts within the f32 route limit of the
    masked-dense tree's, and the served streams of both through the stream
    gate.  Returns the launches and K1's largest error."""
    from collections import Counter

    import numpy as np

    from repro_torch import core
    from repro_torch.configs import get_config
    from repro_torch.kernels.nm_mask import nm_mask, nm_mask_plain
    from repro_torch.kernels.nm_spmm import nm_spmm, nm_spmm_plain
    from repro_torch.models.model import forward, init_params
    from repro_torch.sparse_infer import CompressedTensor, decompress_params, export_compressed
    from repro_torch.utils.tree import tree_items

    cfg = get_config("qwen2-vl-2b")
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scfg = core.domino_search(params, core.SparsityConfig(), m=DOMINO_M,
                              target_density=DOMINO_DENSITY)
    secs = time.perf_counter() - t0
    ratios = core.assigned_ratios(scfg)
    sizes = {name: p.numel() for name, p in tree_items(params)}
    kept = sum(sizes[n] * int(r.split(":")[0]) for n, r in ratios.items()) / DOMINO_M
    share = kept / sum(sizes[n] for n in ratios)
    hist = dict(sorted(Counter(ratios.values()).items()))
    # K4 runs once a slice of each leaf kept below n = m (n:m with n = m
    # keeps everything and launches nothing)
    slices = sum(p.shape[0] if p.dim() >= 3 else 1 for n, p in tree_items(params)
                 if n in ratios and not ratios[n].startswith(f"{DOMINO_M}:"))
    log(f"  domino_search(m={DOMINO_M}, target_density={DOMINO_DENSITY}) on qwen2-vl-2b: "
        f"{secs:.2f} s, kept share {share:.4f}; n:8 by leaf {json.dumps(ratios)}; "
        f"histogram {hist}")
    if share > DOMINO_DENSITY + 1e-9 or len(ratios) != 8:
        raise AssertionError(f"domino: kept share {share}, {len(ratios)} leaves")
    recipe = core.make_recipe("step", scfg)
    dispatch.reset_launches()
    comp, rep = export_compressed(params, recipe)
    del params
    torch.cuda.synchronize()
    export_launches = dict(dispatch.launches)
    log(f"  domino export: {json.dumps(rep)}; launches {({k: v for k, v in export_launches.items() if v})}, "
        f"want nm_mask {slices} (one a maskable leaf slice)")
    if export_launches["nm_mask"] != slices or sum(export_launches.values()) != slices:
        raise AssertionError(f"domino export launched {export_launches}, want nm_mask {slices}")
    for name, leaf in tree_items(comp):
        if name in ratios and not (isinstance(leaf, CompressedTensor)
                                   and f"{leaf.n}:{leaf.m}" == ratios[name]):
            raise AssertionError(f"domino export: {name} is not {ratios[name]}")
    err = 0.0
    gen = torch.Generator(device=dev).manual_seed(14)
    for name in ratios:
        if not name.startswith("body/"):
            continue
        w = k1_leaf(comp, name.split("/", 2)[2])
        for b in (4, 64):
            x = torch.randn((b, w.values.shape[0] * w.m // w.n), generator=gen,
                            device=dev).to(torch.bfloat16)
            args = (x, w.values, w.indices, w.n, w.m, w.out_features)
            err = max(err, check_close(f"nm_spmm {name} {w.n}:{w.m} B={b}", nm_spmm(*args),
                                       nm_spmm_plain(*args)))
    for n in sorted({int(r.split(":")[0]) for r in ratios.values()} - {DOMINO_M}):
        wk = torch.randn((cfg.d_model, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
        got, want = nm_mask(wk, n, DOMINO_M), nm_mask_plain(wk, n, DOMINO_M)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"nm_mask {n}:{DOMINO_M} differs from its plain version")
    log(f"  nm_mask at each assigned n:{DOMINO_M} below {DOMINO_M}:{DOMINO_M}: bit-exact "
        f"against its plain version")
    prompts = [np.random.default_rng(1300 + r).integers(0, cfg.vocab, 64).tolist()
               for r in range(DOMINO_PROMPTS)]
    run = dict(paged=False, lanes=DOMINO_PROMPTS, gen=DOMINO_GEN, prompts=prompts)
    dispatch.reset_launches()
    eng, _, streams, wall = serve(torch, cfg, comp, dev, **run)
    launches = dict(dispatch.launches)
    want = {k: 0 for k in launches}
    want["nm_spmm"] = k1_per_layer(cfg) * cfg.n_layers * (eng.decode_steps + eng.prefill_batches)
    st = eng.stats()
    log(f"  serve qwen2-vl-2b domino n:8 " + json.dumps({
        "tokens_per_s": st["tokens_per_s"], "ms_per_decode_step": st["ms_per_decode_step"],
        "decode_steps": st["decode_steps"], "prefill_batches": st["prefill_batches"],
        "weight_bytes_per_step": st["weight_bytes_per_step"], "run_wall_s": wall,
        "launches": {k: v for k, v in launches.items() if v}}))
    if launches != want:
        raise AssertionError(f"domino serve: launches {launches}, want {want}")
    del eng
    cfg32, comp32 = f32_twin(torch, cfg, comp)
    del comp
    torch.cuda.empty_cache()
    dense32 = decompress_params(comp32)
    toks = torch.tensor(prompts, device=dev)
    with torch.no_grad():
        diff = (forward(comp32, cfg32, toks)[0] - forward(dense32, cfg32, toks)[0]).abs().max()
    log(f"  domino f32 twins, forward of the 4 prompts, compressed n:8 vs masked-dense: max "
        f"|diff| {diff.item():.3e} (limit {DS_ROUTE_F32_TOL})")
    if not diff.item() <= DS_ROUTE_F32_TOL:
        raise AssertionError(f"domino: the f32 forward differs by {diff.item()}")
    a = serve(torch, cfg32, comp32, dev, **run)[2]
    b = serve(torch, cfg32, dense32, dev, **run)[2]
    gate_streams(torch, "domino n:8 vs its masked-dense tree", cfg32, comp32, prompts, a, b)
    del comp32, dense32
    torch.cuda.empty_cache()
    return {"launches": {k: launches[k] + export_launches[k] for k in launches},
            "k1_err": err, "seconds": secs, "histogram": hist}


def frontends_phase(torch, dev, dispatch) -> dict:
    """Phase 13: the first ARCH_LAYERS layers of qwen2-vl-2b (slab, fp and
    int8 pools) and musicgen-large (slab, fp pool) served at full width, each with ``frontend_check``;
    qwen2-vl-2b trained for 10 steps through the train CLI's stub branch;
    DominoSearch.  Returns the launches of K1, K2, K2q and K4 summed over
    its runs, each part's seconds, K1's largest error and its times at
    ``frontend_proj``, and the search's seconds and histogram."""
    out = {"nm_spmm": 0, "paged_attn": 0, "paged_attn_q": 0, "nm_mask": 0}
    seconds, err, extra = {}, 0.0, {"frontend_proj": {}}

    def check(cfg, comp):
        e, extra["frontend_proj"][cfg.name] = frontend_check(torch, dispatch, cfg, comp, dev)
        return e

    def domino():
        rec = domino_phase(torch, dev, dispatch)
        extra["domino"] = {k: rec[k] for k in ("seconds", "histogram")}
        return rec["launches"], rec["k1_err"]

    parts = (("qwen2-vl-2b", lambda: attn_arch_phase(
                 torch, dev, dispatch, "qwen2-vl-2b", ("slab", "fp", "int8"), ARCH_LAYERS,
                 extra=check)),
             ("musicgen-large", lambda: attn_arch_phase(
                 torch, dev, dispatch, "musicgen-large", ("slab", "fp"), ARCH_LAYERS,
                 extra=check)),
             ("train qwen2-vl-2b", lambda: (train_phase(
                 torch, dev, dispatch, argv=FRONT_TRAIN_ARGS, profile=False), 0.0)),
             ("domino", domino))
    for name, part in parts:
        t0 = time.perf_counter()
        launches, e = part()
        err = max(err, e)
        for k in out:
            out[k] += launches.get(k, 0)
        seconds[name] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
        log(f"  {name}: {seconds[name]} s, launches "
            f"{({k: v for k, v in launches.items() if v})}")
    return {"launches": out, "seconds": seconds, "k1_err": err, **extra}


def _leaves(tree):
    from repro_torch.utils.tree import tree_items

    return [leaf for _, leaf in tree_items(tree)]


def _median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2]


def train_phase(torch, dev, dispatch, ckpt_dir=None, argv=TRAIN_ARGS, profile=True) -> dict:
    """Phase 4 (and phase 13's qwen2-vl-2b): STEP training through the
    launcher's Trainer, checkpointing to ``ckpt_dir`` where given.  The loss
    and gradient norm finite at every step, the loss falling (the mean of the
    last third of the steps, at most 10, below the first's), the switch
    inside AutoSwitch's clip, ``nm_mask`` launched once a maskable leaf per
    masked step and per leaf at export, the export exactly N:M; with
    ``profile``, a trace of a few steps of each phase.  Returns the
    nm_mask launches of the run and its export."""
    import numpy as np

    from repro_torch.launch import train as launch_train

    args = launch_train.parse_args(argv + (["--ckpt-dir", ckpt_dir] if ckpt_dir else []))
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
    summary = launch_train.summarize(run, state, args, dev)  # the export: one a leaf
    launches = dict(dispatch.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in hist]
    bad = [m["step"] for m in hist if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]))]
    if bad or len(hist) != args.steps:
        raise AssertionError(f"non-finite loss or grad norm at steps {bad} ({len(hist)} logged)")
    k = min(10, max(1, args.steps // 3))
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    log(f"  loss: first {k} steps {first:.4f}, last {k} {last:.4f}; per step "
        f"{[round(x, 3) for x in losses]}")
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    t_sw = state.opt.t0
    if not (state.opt.phase2 and asw.t_min < t_sw <= asw.t_max + 1):
        raise AssertionError(f"switch at t0={t_sw}, outside ({asw.t_min}, {asw.t_max + 1}]")
    masked_steps = sum(int(m["mask_active"]) for m in hist)
    leaves = len(_maskable(run.recipe, state.params))
    want = leaves * (masked_steps + 1)
    log(f"  t0 {t_sw}, masked steps {masked_steps}, launches {launches} "
        f"(nm_mask wants {leaves} x {masked_steps} + {leaves} = {want})")
    if launches["nm_mask"] != want:
        raise AssertionError(f"nm_mask launched {launches['nm_mask']} times, want {want}")
    sparse = run.recipe.export_sparse(state.params)
    for name, p in _maskable(run.recipe, sparse):
        pat = run.recipe.sparsity.pattern_for(name, tuple(p.shape))
        nz = (p != 0).movedim(-2, -1).reshape(-1, pat.m).sum(-1)
        if not bool((nz <= pat.n).all()):
            raise AssertionError(f"exported {name} is not {pat}")
    del sparse
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
        "arch": run.cfg.name, "device": torch.cuda.get_device_name(0),
    }))
    if not profile:
        return launches
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
    share, kernels launched per step, the six kernels with the most
    device time, and how many of the window's lead records kineto dropped
    (``open_trace``).  Returns the record and the advanced state."""
    from torch.profiler import ProfilerActivity, profile

    state, _ = step_fn(state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_trace(torch)
        t0 = time.perf_counter()
        for b in batches[1:]:
            state, _ = step_fn(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = len(batches) - 1
    kernels, dropped = traced_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "ms_per_step": wall_ms / n,
        "device_busy_ms_per_step": busy_ms / n if busy_ms > 0 else "not measured",
        "idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else "not measured",
        "kernels_per_step": sum(e.count for e in kernels) / n,
        "top_kernels_ms_per_step": {e.key[:70]: e.self_device_time_total / 1e3 / n for e in top},
        "lead_records_dropped": dropped,
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


def phase_done(seconds: dict, phase: str, t0: float) -> float:
    """Log and keep a phase's seconds; returns the next phase's start."""
    now = time.perf_counter()
    seconds[phase] = round(now - t0, 1)
    log(f"  phase {phase}: {seconds[phase]} s")
    return now


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
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s into {out}; each compile's "
        f"seconds {json.dumps(dispatch.build_seconds)}")
    for name in dispatch.SOURCES:
        log_file = out / f"{name}.log"
        for line in (log_file.read_text().splitlines() if log_file.exists() else []):
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    seconds = {"1": round(time.perf_counter() - t_start, 1)}
    t_phase = time.perf_counter()
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
    log("phase 2: paged_attn's GQA form and its int8 form (K2, K2q) at D = 128, G = 12 and 3 "
        "(starcoder2-3b's and minitron-4b's heads), both flushes")
    d128 = check_gqa_heads(torch, dev)
    log("phase 2: paged_attn's stats form (K3) in its six forms, and split over 2 and 4 page "
        "ranges against K2")
    for form in ("gqa", "window", "mla"):
        for int8 in (False, True):
            name = entry(mla=form == "mla", window=form == "window", stats=True, quant=int8)
            records[name] = check_paged_attn_stats(torch, dev, form, first, int8)

    t_phase = phase_done(seconds, "2", t_phase)
    log("phase 3: serve full-width gpt2-paper: slab, undersized paged pool, int8 pool of "
        "the same bytes; their f32 twins")
    launches, single = serve_phase(torch, cfg, comp, dev, dispatch)
    t_phase = phase_done(seconds, "3", t_phase)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        log("phase 4: train full-width gpt2-paper with STEP (2:4, batch 8, seq 128, 60 steps)")
        launches["nm_mask"] = train_phase(torch, dev, dispatch, ckpt_dir)["nm_mask"]
        t_phase = phase_done(seconds, "4", t_phase)
        log("phase 5: serve the trained checkpoint, compressed")
        serve_trained_phase(torch, cfg, dev, dispatch, ckpt_dir)
        t_phase = phase_done(seconds, "5", t_phase)

    log(f"phase 6: serve full-width DeepSeek-V2-Lite (its first {DS_LAYERS} of 27 layers): "
        "slab, paged, preempting, int8 pool, chunked prefill with the prefix cache; f32 twins of the slab and the paged "
        "pool, and of the cold and the chunked pool")
    ds = deepseek_phase(torch, dev, dispatch)
    ds_chunk_launches = ds.pop("chunk_dispatch_launches")
    ds_spec = ds.pop("spec_tree")
    launches.update(ds)
    t_phase = phase_done(seconds, "6", t_phase)

    log(f"phase 7: serve full-width RecurrentGemma-9B (its first {RG_LAYERS} of 38 layers): "
        "slab, paged, preempting, int8 pool; f32 twins of the slab and the paged pool")
    rg = recurrentgemma_phase(torch, dev, dispatch)
    launches["paged_attn_win"] = rg["paged_attn_win"]
    launches["paged_attn_win_q"] = rg["paged_attn_win_q"]
    t_phase = phase_done(seconds, "7", t_phase)

    log(f"phase 8: serve every family tensor-parallel on {MESH_RANKS} ranks of the one card: "
        f"gpt2-paper's and Mamba2-2.7B's first {MESH_LAYERS} layers, DeepSeek-V2-Lite's first "
        f"{1 + DS_TWIN_BODY}, RecurrentGemma-9B's first period, each on the slab and its pools, "
        "then their f32 twins")
    mesh = mesh_phase(torch, cfg, dev, single)
    for name in K3_FORMS:
        launches[name] = mesh[name]
    t_phase = phase_done(seconds, "8", t_phase)

    log(f"phase 9: serve full-width gpt2-paper with the device scheduler (CUDA graphs, "
        f"{DEV_K} steps a dispatch): exact against the sync scheduler, refills against the "
        f"f32 twins, launches against the profiler")
    device_phase(torch, cfg, comp, dev, single)
    t_phase = phase_done(seconds, "9", t_phase)

    log(f"phase 10: serve full-width gpt2-paper with chunked prefill (chunks of {CHUNK}) and "
        f"the prefix cache: slab, fp and int8 pools, the device scheduler; their f32 twins")
    chunk_launches = add_launches(chunk_phase(torch, cfg, comp, dev), ds_chunk_launches)
    t_phase = phase_done(seconds, "10", t_phase)

    log(f"phase 11: self-speculative decoding: full-width gpt2-paper (2:4 drafter, masked-dense "
        f"and 4:8 verifiers, gamma {SPEC_GAMMA} and {SPEC_GAMMA_REJECT}) and DeepSeek-V2-Lite's "
        f"first {1 + DS_SPEC_BODY} layers (gamma {DS_SPEC_GAMMA}); their f32 twins")
    spec = spec_phase(torch, cfg, comp, dev, single, ds_spec)
    records["nm_spmm"]["max_abs_err"] = max(records["nm_spmm"]["max_abs_err"], spec["verify_err"])
    del comp, ds_spec
    t_phase = phase_done(seconds, "11", t_phase)

    log(f"phase 12: the reference's other token archs at full width: starcoder2-3b's first "
        f"{ARCH_LAYERS} of 30 layers (slab, fp and int8 pools), minitron-4b's first {MT_LAYERS} "
        f"(fp pool), mamba2-2.7b's first {MAMBA_LAYERS} of 64 (slab, table-less pool, the device "
        "scheduler); their f32 twins")
    archs = archs_phase(torch, dev, dispatch)
    records["nm_spmm"]["max_abs_err"] = max(records["nm_spmm"]["max_abs_err"], archs["k1_err"])
    for name, n in archs["launches"].items():
        launches[name] += n
    t_phase = phase_done(seconds, "12", t_phase)

    log(f"phase 13: the stub-frontend archs at full width, their first {ARCH_LAYERS} layers: "
        "qwen2-vl-2b (M-RoPE; slab, fp and int8 pools) and musicgen-large (slab, fp pool) "
        "with forwards over embeds, their f32 twins; "
        "qwen2-vl-2b trained 10 steps; DominoSearch's mixed n:8 served")
    heads = check_gqa_heads(torch, dev, FRONT_HEADS)
    front = frontends_phase(torch, dev, dispatch)
    records["nm_spmm"]["max_abs_err"] = max(records["nm_spmm"]["max_abs_err"], front["k1_err"])
    for name, n in front["launches"].items():
        launches[name] += n
    log(f"  phase 13 parts: {json.dumps(front['seconds'])}")
    phase_done(seconds, "13", t_phase)

    kernels = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}.cu", "replaces": replaces,
            "launches": launches[name], **{k: rec[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "at")},
            **{k: rec[k] for k in ("sdpa_yardstick_ms", "splits", "first_version_bytes",
                                   "prefill", "sharded") if k in rec},
            **({"chunk_dispatch_launches": chunk_launches[name]}
               if name in chunk_launches else {}),
            **({"spec_round_launches": spec["launches"][name]}
               if name in spec["launches"] else {}),
            **({"spec_verify_profile": spec["verify_profile"]} if name == "nm_spmm" else {}),
            **({"phase12_launches": archs["launches"][name]} if name in archs["launches"]
               else {}),
            **({"d128": d128[name]} if name in d128 else {}),
            **({"phase13_launches": front["launches"][name]} if name in front["launches"]
               else {}),
            **({"phase13_heads": heads[name]} if name in heads else {}),
            **({"phase8_launches": mesh[name]} if mesh.get(name) else {}),
            **({"frontend_proj": front["frontend_proj"]} if name == "nm_spmm" else {}),
            **({"domino": front["domino"]} if name == "nm_mask" else {}),
        })
    log(f"  total {time.perf_counter() - t_start:.1f} s; by phase {json.dumps(seconds)}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
