#!/usr/bin/env python3
"""Times K1/K1b's prefill body (``nm_spmm_tc`` in
``src/repro_torch/csrc/nm_spmm.cu``) with each of its output tiles at the
row counts the port's serving runs give each weight shape, and checks that
every tile gives the same bytes.

    python3 scripts/nm_spmm_tiles.py [--out FILE]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``
(the kernels are built from the checkout's sources at first use).  For
each shape and row count it prints one JSON object per tile: the median
CUDA-event time of one call (``chip_smoke.time_ms``: L2 flushed before
each), the tile's blocks and the kernel's rate in TFLOP/s of kept
products; then, per shape, each tile's time summed over its row counts
and the tile ``prefill_plan`` picks.  ``--out`` also writes the objects to
``FILE``, one a line.  Exits 1 if two tiles give different bytes.

Row counts (2:4, bf16, weights at the init scale, x standard normal):
gpt2-paper's prefill batch of four 64-token prompts (256 rows); DeepSeek-
V2-Lite's 64-token prompt groups of 1, 2 or 4 (64, 128, 256 rows) at its
dense layer 0 and its expert stacks (C = 16 and 32 rows an expert of 64);
RecurrentGemma-9B's exact-length prefills of 64, 1200, 2032 and 2100
rows at its 4096-wide projections and MLP.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (name, K, O, experts, row counts)
CASES = (
    ("gpt2 wq/wk/wv/wo", 768, 768, 1, (256,)),
    ("gpt2 w_fc", 768, 3072, 1, (256,)),
    ("gpt2 w_proj", 3072, 768, 1, (256,)),
    ("deepseek layer 0 w_gate/w_up", 2048, 10944, 1, (64, 128, 256)),
    ("deepseek layer 0 w_down", 10944, 2048, 1, (64, 128, 256)),
    ("deepseek experts w_gate_e/w_up_e", 2048, 1408, 64, (16, 32)),
    ("deepseek experts w_down_e", 1408, 2048, 64, (16, 32)),
    ("recurrentgemma 4096x4096 (RG-LRU, wq, wo)", 4096, 4096, 1, (64, 1200, 2032, 2100)),
    ("recurrentgemma w_fc", 4096, 12288, 1, (64, 1200, 2032, 2100)),
    ("recurrentgemma w_proj", 12288, 4096, 1, (64, 1200, 2032, 2100)),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("nm_spmm_tiles: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import nm_spmm as k1

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dispatch.build()
    dispatch.load_kernels()
    chosen_by_rule = k1.prefill_plan
    tiles = (k1.TC_SMALL, k1.TC_EXPERTS)
    gen = torch.Generator(device=dev).manual_seed(7)
    records, ok = [], True

    def emit(rec: dict) -> None:
        records.append(rec)
        print(json.dumps(rec), flush=True)

    try:
        for name, k, o, e, row_counts in CASES:
            vals, idx = chip_smoke.random_stack(torch, e, k, o, gen, dev)
            vals = (vals.float() * k ** -0.5).to(torch.bfloat16)
            rule = chosen_by_rule(k, o, e, 2, 4, 2)
            totals = {}
            for b in row_counts:
                x = torch.randn((e, b, k), generator=gen, device=dev).to(torch.bfloat16)
                if e == 1:
                    x, w = x[0], (vals[0], idx[0])

                    def call():
                        return k1.nm_spmm(x, *w, 2, 4)
                else:
                    def call():
                        return k1.nm_spmm_batched(x, vals, idx, 2, 4)
                first = None
                for tile in tiles:
                    plan = k1.PrefillPlan(*tile, rule.depth)
                    if k1.prefill_smem_bytes(plan, 2, 4) > k1.SMEM_MAX:
                        continue
                    k1.prefill_plan = lambda *_, plan=plan: plan
                    y = call()
                    same = first is None or torch.equal(y.view(torch.uint8),
                                                        first.view(torch.uint8))
                    first = y if first is None else first
                    ok &= same
                    ms = chip_smoke.time_ms(torch, call)
                    blocks = e * -(-b // tile[0]) * -(-o // tile[1])
                    totals[tile] = totals.get(tile, 0.0) + ms
                    emit(dict(shape=name, k=k, o=o, experts=e, rows=b, tile=list(tile),
                              blocks=blocks, ms=ms, same_bytes_as_first_tile=same,
                              kept_tflops=2.0 * e * b * (k // 2) * o / ms / 1e9))
                    k1.prefill_plan = chosen_by_rule
            best = min(totals, key=totals.get)
            emit(dict(shape=name, rows=list(row_counts), summed_ms={
                f"{t[0]}x{t[1]}": v for t, v in totals.items()},
                best=f"{best[0]}x{best[1]}", rule=f"{rule.rows}x{rule.cols}",
                sm_count=torch.cuda.get_device_properties(dev).multi_processor_count))
            del vals, idx
    finally:
        k1.prefill_plan = chosen_by_rule
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in records))
    if not ok:
        print("nm_spmm_tiles: two tiles gave different bytes", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
