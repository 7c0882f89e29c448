#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``.
Phases, in order; any failure exits non-zero:

1. Device: print the card's ``nvidia-smi`` name and power limit; build the
   CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in
   parallel).
2. Kernels against their plain PyTorch versions in bf16, at the shapes the
   full-width gpt2-paper serving path gives them; then CUDA-event timings of
   the kernel, the plain version and a one-call PyTorch yardstick, beside
   the least time the card could take (the larger of bytes / 3.35 TB/s and
   operations / 989 TFLOP/s, counted from the shapes).
3. Serve full-width gpt2-paper (random weights from a seed, STEP 2:4
   export, compression) through ``DecodeEngine``: on the slab, then on an
   undersized paged pool that preempts.  Launch counts are zeroed before
   and read after; both kernels must have run.  Every request must finish
   with its token budget, and where the two greedy streams differ the
   top-2 logit margin must be a near-tie.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
# Both the kernel and its plain version round an f32 result to bf16 once;
# f32 results that differ by summation order can round one bf16 step apart,
# and a bf16 step is at most 2^-7 of the value.  ATOL covers outputs near 0.
BF16_RTOL, ATOL = 2.0 ** -7, 1e-5
# A greedy slab token may differ from its paged twin only at a near-tie:
# bf16 logits (|logit| ~ 1) carry about 2^-8 of rounding per operation, and
# 12 layers of it stay well inside 0.1.
MARGIN = 0.1
REPLACES = {
    "nm_spmm": "src/repro/kernels/nm_spmm.py:133",
    "paged_attn": "src/repro/kernels/paged_attn.py:190",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
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


def check_close(name: str, y, ref) -> float:
    err = (y.float() - ref.float()).abs()
    bad = err > BF16_RTOL * ref.float().abs() + ATOL
    log(f"  {name}: max_abs_err {err.max().item():.3e}  (tolerance 2^-7*|ref| + {ATOL}: "
        f"one bf16 rounding step of an f32 result)")
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond tolerance")
    return err.max().item()


def check_nm_spmm(torch, comp: dict, dev) -> dict:
    """K1 at the six matmuls of one gpt2-paper layer (q/k/v/o 768->768,
    fc 768->3072, proj 3072->768), in decode (B = 1, 4, 8) and prefill
    (B = 4 x 64 rows).  The record is one layer's six decode calls at B=4."""
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
            err = check_close(f"nm_spmm {name} B={b} ({k_dim}->{w.out_features})",
                              nm_spmm(*args), nm_spmm_plain(*args))
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
            t["bound_ms"], by = bound_ms(nbytes, 2.0 * b * w.values.shape[0] * w.out_features)
            log(f"  time nm_spmm {name} B={b}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, torch.matmul(dense) {t['library_ms']:.4f} ms, "
                f"bound {t['bound_ms']:.4f} ms ({by})")
            if b == 4:
                for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                    rec[key] += t[key]
                rec["bound_by"] = by
    rec["at"] = "sum of one layer's six decode calls, x (4, K) bf16, 2:4"
    return rec


def check_paged_attn(torch, dev) -> dict:
    """K2 at B=4, H=12, D=64, ps=16: ragged lanes, sentinel slots, one dead
    lane."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attn import paged_attn, paged_attn_plain

    b, h, d, ps, n_slots, num_pages = 4, 12, 64, 16, 7, 40
    lengths = [97, 33, 0, 70]
    gen = torch.Generator(device="cpu").manual_seed(2)
    perm = torch.randperm(num_pages, generator=gen).tolist()
    tables = torch.full((b, n_slots), num_pages, dtype=torch.int32)
    for i, ln in enumerate(lengths):
        for pg in range(-(-ln // ps)):
            tables[i, pg] = perm.pop()
    q, kp, vp = (torch.randn(s, generator=gen).to(torch.bfloat16).to(dev) for s in (
        (b, h, 1, d), (num_pages, ps, h, d), (num_pages, ps, h, d)))
    tables, lens = tables.to(dev), torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = d ** -0.5
    y = paged_attn(q, kp, vp, tables, lens, scale=scale)
    err = check_close("paged_attn B=4 H=12 D=64 ps=16", y,
                      paged_attn_plain(q, kp, vp, tables, lens, scale=scale))
    if float(y[2].abs().max()) != 0.0:
        raise AssertionError("paged_attn: the dead lane is not exactly zero")
    # yardstick: SDPA on the pre-gathered contiguous (B, H, S, D) view
    phys = tables.long().clamp(max=num_pages - 1)
    kg = kp[phys].reshape(b, n_slots * ps, h, d).transpose(1, 2).contiguous()
    vg = vp[phys].reshape(b, n_slots * ps, h, d).transpose(1, 2).contiguous()
    mask = (torch.arange(n_slots * ps, device=dev)[None, :] < lens[:, None])[:, None, None]
    qs = q.reshape(b, h, 1, d)
    live = sum(lengths)
    nbytes = (q.numel() * 2 + 2 * live * h * d * 2 + tables.numel() * 4 + b * 4
              + b * h * d * 2)
    rec = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: paged_attn(q, kp, vp, tables, lens, scale=scale)),
        plain_ms=time_ms(torch, lambda: paged_attn_plain(q, kp, vp, tables, lens, scale=scale)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, scale=scale)),
        at=f"q (4, 12, 1, 64) bf16, ps=16, lengths {lengths}",
    )
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, 4.0 * live * h * d)
    log(f"  time paged_attn: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"SDPA on gathered view {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']})")
    return rec


def serve(torch, cfg, comp, dev, *, paged: bool, n_requests=8, lanes=4, prompt_len=64,
          gen=32, k=4, num_pages=22):
    """One greedy serving run of the port's engine; returns (engine, streams, seconds)."""
    import numpy as np

    from repro_torch.serving import DecodeEngine, SamplingParams

    max_len = prompt_len + gen + 1
    eng = DecodeEngine(cfg, comp, max_batch=lanes, max_len=max_len, seed=0,
                       num_pages=num_pages if paged else None, page_size=16,
                       steps_per_dispatch=k, device=dev)
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


def compare_streams(torch, cfg, comp, prompts, a, b, dev) -> tuple[int, int, list]:
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
        if margins[-1] >= MARGIN:
            raise AssertionError(f"slab and paged streams differ at token {j} with "
                                 f"top-2 margin {margins[-1]:.4f} >= {MARGIN}")
    return agree, total, margins


def serve_phase(torch, cfg, comp, dev, dispatch) -> dict:
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
    name = torch.cuda.get_device_name(0)
    for eng, wall in ((slab, s_wall), (paged, p_wall)):
        st = eng.stats()
        log("  serve " + json.dumps({
            "layout": st["layout"], "tokens_per_s": st["tokens_per_s"],
            "ms_per_decode_step": st["ms_per_decode_step"],
            "ms_per_decode_step_host": st["ms_per_decode_step_host"],
            "decode_steps": st["decode_steps"], "preemptions": st["preemptions"],
            "max_concurrency": st["max_concurrency"], "run_wall_s": wall,
            "weight_bytes_per_step": st["weight_bytes_per_step"],
            "weight_stream_bound_ms": st["weight_bytes_per_step"] / HBM_BYTES_PER_S * 1e3,
            "peak_memory_bytes": peak, "device": name,
        }))
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
    from repro_torch.models.model import init_params
    from repro_torch.sparse_infer import compress_params

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
    t0 = time.perf_counter()
    out = dispatch.build()
    dispatch.load_kernels()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s into {out}")
    for name in dispatch.KERNELS:
        log_file = out / f"{name}.log"
        for line in (log_file.read_text().splitlines() if log_file.exists() else []):
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("phase 2: kernels against their plain versions (bf16, gpt2-paper shapes)")
    cfg = get_config("gpt2-paper")
    params = init_params(cfg, seed=0, device=dev)
    recipe = core.make_recipe("step", core.SparsityConfig(default=core.NMSparsity(2, 4)))
    comp = compress_params(recipe.export_sparse(params), recipe.sparsity)
    del params
    records = {"nm_spmm": check_nm_spmm(torch, comp, dev),
               "paged_attn": check_paged_attn(torch, dev)}

    log("phase 3: serve full-width gpt2-paper, slab then undersized paged pool")
    launches = serve_phase(torch, cfg, comp, dev, dispatch)

    kernels = []
    for name, rec in records.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu", "replaces": REPLACES[name],
            "launches": launches[name], **{k: rec[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "at")},
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
