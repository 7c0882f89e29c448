"""Serving launcher: compressed-native continuous-batching decode on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \\
        [--arch gpt2-paper|deepseek-v2-lite-16b|recurrentgemma-9b] \\
        [--paged --page-size 16 --num-pages 64 [--kv-int8]] [--steps-per-dispatch 4] \\
        [--ckpt-dir RUN] [--dense] [--temperature 0.8 --top-k 40] [--device cpu]

Counterpart of ``repro/launch/serve.py`` (sync scheduler only).  Loads or
initializes the parameters, applies the final STEP N:M mask (Π_T ⊙ w_T),
compresses the maskable leaves and serves the compressed tree through
``DecodeEngine``: every matmul of prefill and decode runs the ``nm_spmm``
kernel (MoE expert stacks its batched form, RG-LRU blocks all five
projections), and ``--paged`` decode attention the ``paged_attn`` kernel
(MLA its latent form; sliding-window layers its window form over the
modular window table, once ``prompt_len + gen + 1`` reaches the window;
``--kv-int8`` stores the pages as int8 with per-(page, slot) scales and
runs each form's int8 option).
Export and compression go leaf by leaf (``export_compressed``), so a
full-width DeepSeek-V2-Lite fits one 80 GB card.  ``--dense`` serves the masked-dense
tree instead.  Prints two JSON lines: the compression report and the run
summary, with the reference's keys.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch import core
from repro_torch.checkpoint import restore_latest
from repro_torch.configs import get_config, list_archs
from repro_torch.models.model import init_params
from repro_torch.serving import DecodeEngine, SamplingParams
from repro_torch.sparse_infer import export_compressed
from repro_torch.utils.device import resolve_device


def build_serving_state(args, device) -> tuple:
    """``(cfg, serving_tree, compression_report)`` from the CLI args."""
    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_params(cfg, seed=0, device=device)
    if args.ckpt_dir:
        # training checkpoints hold the whole train state; read its params
        restored = restore_latest(args.ckpt_dir, prefix="params", device=device)
        if restored is not None:
            params, _, step = restored
            print(f"# restored params from step {step}")
    n, m = (int(x) for x in args.nm.split(":"))
    recipe = core.make_recipe("step", core.SparsityConfig(default=core.NMSparsity(n, m)))
    # Π_T ⊙ w_T, compressed unless --dense; consumes params leaf by leaf
    served, rep = export_compressed(params, recipe, compress=not args.dense)
    return cfg, served, rep


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-paper", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--nm", default="2:4")
    ap.add_argument("--batch", type=int, default=4, help="decode lanes")
    ap.add_argument("--requests", type=int, default=None,
                    help="total requests (default: one per lane)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--dense", action="store_true",
                    help="serve the masked-dense tree (A/B baseline)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV-cache pool instead of the per-lane slab")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV pages with per-page-row scales (~2x the tokens of "
                         "bf16 pages at equal bytes; paged only)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pages in the pool (default: slab-equivalent "
                         "batch*ceil(max_len/page_size))")
    ap.add_argument("--prefill-buckets", default=None,
                    help="comma-separated prompt-pad lengths for batched prefill "
                         "(default: powers of two)")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="decode steps per host sync")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.kv_int8 and not args.paged:
        raise SystemExit("--prefix-cache/--kv-int8 require --paged")  # the reference's words
    device = resolve_device(args.device)
    cfg, serving_tree, rep = build_serving_state(args, device)
    print(json.dumps({"compression": rep}))

    max_len = args.prompt_len + args.gen + 1
    num_pages = args.num_pages
    if args.paged and num_pages is None:
        num_pages = args.batch * (-(-max_len // args.page_size))
    buckets = ([int(b) for b in args.prefill_buckets.split(",")]
               if args.prefill_buckets else None)
    engine = DecodeEngine(
        cfg, serving_tree, max_batch=args.batch, max_len=max_len, seed=0,
        num_pages=num_pages if args.paged else None, page_size=args.page_size,
        steps_per_dispatch=args.steps_per_dispatch, kv_quant=args.kv_int8,
        prefill_buckets=buckets, device=device,
    )
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              max_new_tokens=args.gen)
    n_requests = args.batch if args.requests is None else args.requests
    for r in range(n_requests):
        prompt = np.random.default_rng(1000 + r).integers(0, cfg.vocab, args.prompt_len)
        engine.submit(prompt.tolist(), sampling)
    results = engine.run()
    summary = make_summary(cfg, engine, results, rep, args)
    print(json.dumps({"summary": summary}))
    return summary


def make_summary(cfg, engine: DecodeEngine, results: dict, rep: dict, args) -> dict:
    """The reference's summary keys; features not ported yet report their
    idle values (sync scheduler, no chunking, no refills, no mesh)."""
    st = engine.stats()
    summary = {
        "arch": cfg.name,
        "compressed": not args.dense,
        "layout": st["layout"],
        "n_requests": len(results),
        "generated_tokens": st["tokens_generated"],
        "tokens_per_s": st["tokens_per_s"],
        "ms_per_decode_step": st["ms_per_decode_step"],
        "ms_per_decode_step_host": st["ms_per_decode_step_host"],
        "host_overhead_frac": st["host_overhead_frac"],
        "decode_steps": st["decode_steps"],
        "dispatches": st["dispatches"],
        "steps_per_dispatch": st["steps_per_dispatch"],
        "scheduler": "sync",
        "host_syncs": st["host_syncs"],
        "refills": 0,
        "itl_ms_p50": st["itl_ms_p50"],
        "itl_ms_p99": st["itl_ms_p99"],
        "prefill_batches": st["prefill_batches"],
        "prefill_chunks": 0,
        "max_concurrency": st["max_concurrency"],
        "preemptions": st["preemptions"],
        "kv_cache_bytes": st["kv_cache_bytes"],
        "hbm_weight_ratio": round(rep["ratio"], 3),
        "mesh": None,
        "kernel_route": engine.kernel_route(),
    }
    if args.paged:
        summary.update(
            evicted_pages=st["evicted_pages"], table_full_uploads=st["table_full_uploads"],
            table_row_syncs=st["table_row_syncs"], table_syncs=st["table_syncs"],
            kv_quant=st["kv_quant"], shared_pages=0, cow_copies=0,
        )
    if args.temperature == 0.0:
        summary["greedy_streams"] = [[int(t) for t in results[u].tokens]
                                     for u in sorted(results)]
    return summary


if __name__ == "__main__":
    main()
