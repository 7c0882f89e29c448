"""Serving launcher: compressed-native continuous-batching decode on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \\
        [--arch gpt2-paper|starcoder2-3b|minitron-4b|mamba2-2.7b|...] \\
        [--paged --page-size 16 --num-pages 64 [--kv-int8]] [--steps-per-dispatch 4] \\
        [--max-steps-per-dispatch 16 [--staged-lanes 2] [--async-stream]] \\
        [--prefill-chunk 64] [--prefix-cache [--shared-prefix 128]] \\
        [--ckpt-dir RUN] [--dense] [--temperature 0.8 --top-k 40] [--device cpu] \\
        [--mesh 1,2 [--kv-shard seq]] [--spec-gamma 4|auto] [--no-donate]

Counterpart of ``repro/launch/serve.py``; ``--arch`` takes every
token-input arch of ``configs.list_archs()``: like the reference's CLI it
refuses the two with stub frontends (qwen2-vl-2b, musicgen-large), whose
prompts would be embeddings (``DecodeEngine`` still serves their token
paths, M-RoPE's positions broadcast over its three streams).
``--no-donate`` is accepted for parity and does nothing: the reference
donates its cache buffers to the jitted decode, and PyTorch updates the
cache in place, so there is nothing to donate.  Loads or
initializes the parameters, applies the final STEP N:M mask (Π_T ⊙ w_T),
compresses the maskable leaves and serves the compressed tree through
``DecodeEngine``: every matmul of prefill and decode runs the ``nm_spmm``
kernel (MoE expert stacks its batched form, RG-LRU blocks all five
projections, Mamba-2 blocks ``w_in`` and ``w_out``), and ``--paged``
decode attention the ``paged_attn`` kernel
(MLA its latent form; sliding-window layers its window form over the
modular window table, once ``prompt_len + gen + 1`` reaches the window;
``--kv-int8`` stores the pages as int8 with per-(page, slot) scales and
runs each form's int8 option).
Export and compression go leaf by leaf (``export_compressed``), so a
full-width DeepSeek-V2-Lite fits one 80 GB card.  ``--dense`` serves the masked-dense
tree instead.  Prints two JSON lines: the compression report and the run
summary, with the reference's keys.

``--max-steps-per-dispatch K`` serves with the device scheduler
(``serving.device_loop``: run-until-stop decode of up to K steps a
dispatch, a captured CUDA graph on the card; ``--staged-lanes Q`` refills
frozen lanes inside the dispatch from Q staged prompts, ``--async-stream``
runs two dispatches a cycle); the summary gains its counters.

``--prefill-chunk C`` absorbs prompts longer than C in chunks of C
interleaved with decode (attention-family archs; a windowed one on
``--paged`` only); ``--prefix-cache`` (``--paged``) shares the KV pages
of cached prompt prefixes between requests, and ``--shared-prefix N``
gives every request the same first N prompt tokens to exercise it.  The
summary gains ``prefill_chunks``, the prefix counters and ``cow_copies``.

``--spec-gamma N|auto`` serves with self-speculative decoding: the served
tree (compressed, or masked-dense under ``--dense``) drafts N tokens a
lane a round and the masked-dense tree of the same export verifies them
in one chunked pass (``auto`` picks N from the two trees' bytes).  The
verifier is rebuilt from the compressed tree (``decompress_params``), so
the unmasked tree never sits beside the two.  The summary gains the
acceptance counters.  Attention-family archs without a window, the sync
scheduler, no model or data axis > 1.  On an attention-free arch (mamba2-2.7b)
``--paged`` serves a pool without tables or pages, its states per lane,
and chunked prefill and the prefix cache are refused with a warning, as
on RG-LRU archs.

``--mesh data,model`` serves on a mesh of local ranks (every token-input
arch, on the slab or ``--paged``, with or without ``--kv-int8``): over
the model axis each rank holds its shard of the tree and its rows of
every lane of the slab or its page range of the pool; over the data axis
each data row decodes its own ``batch / data`` lanes (every lane where
``data`` does not divide ``--batch``), their token blocks gathered over
the data group each dispatch, e.g. ``--mesh 2,2``.  Chunks, the prefix
cache, ``--spec-gamma`` and the device scheduler are refused on a mesh
larger than 1×1.  The export happens once
here, then ``data × model`` ranks start
(``launch.mesh.run_ranks``: ``gloo`` where ranks share a card or run on the
CPU, ``nccl`` where each has a card of its own; the choice is printed),
each keeps its shard of the tree and of the pool, and rank 0's summary is
printed with ``mesh``, the collectives per decode step and every rank's
weight and KV bytes (``per_rank``).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import core
from repro_torch.checkpoint import restore_latest
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_local_mesh, run_ranks
from repro_torch.models.model import forward, init_params
from repro_torch.serving import DecodeEngine, SamplingParams
from repro_torch.sparse_infer import CompressedTensor, decompress_params, export_compressed
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_items, tree_map_with_name


def build_serving_state(args, device) -> tuple:
    """``(cfg, serving_tree, compression_report, verifier)`` from the CLI
    args; ``verifier`` (the masked-dense Π_T ⊙ w_T tree, the speculative
    verifier) is None without ``--spec-gamma``."""
    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_params(cfg, seed=0, device=device)
    if args.ckpt_dir:
        # training checkpoints hold the whole train state; read its params
        restored = restore_latest(args.ckpt_dir, prefix="params", device=device)
        if restored is not None:
            params, _, step = restored
            print(f"# restored params from step {step}")
    # Π_T ⊙ w_T, compressed unless --dense; consumes params leaf by leaf
    served, rep = export_compressed(params, step_recipe(args.nm), compress=not args.dense)
    verifier = None
    if args.spec_gamma is not None:
        # the masked-dense tree of the same export; under --dense the drafter
        # is the verifier (acceptance 1 by construction)
        verifier = served if args.dense else decompress_params(served)
    return cfg, served, rep, verifier


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
    ap.add_argument("--max-steps-per-dispatch", type=int, default=None,
                    help="device-resident scheduler: run-until-stop decode of up to this "
                         "many steps a dispatch, replayed as a CUDA graph on the card")
    ap.add_argument("--staged-lanes", type=int, default=0,
                    help="queued prompts staged each cycle so that frozen lanes refill "
                         "inside the dispatch (needs --max-steps-per-dispatch)")
    ap.add_argument("--async-stream", action="store_true",
                    help="two dispatches a cycle: the host replays the first while the "
                         "second runs (needs --max-steps-per-dispatch)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="absorb prompts longer than this in chunks of this many tokens "
                         "interleaved with decode (attention-family archs only)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share the KV pages of cached prompt prefixes across requests "
                         "(paged, attention-family archs); hits prefill only their tail")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every request the same first N prompt tokens (exercises "
                         "--prefix-cache; the tails stay random per request)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--mesh", default=None,
                    help="serve on a 'data,model' mesh of local ranks (e.g. --mesh 2,2): "
                         "compressed weights, the slab's rows and the pool's pages shard over "
                         "the model axis, the lanes over the data axis")
    ap.add_argument("--kv-shard", default="seq", choices=("seq", "feature"),
                    help="model-axis dim of the KV pool under --mesh")
    ap.add_argument("--no-donate", dest="donate", action="store_false", default=True,
                    help="accepted for parity with the reference's CLI; no effect (the "
                         "cache is updated in place, there is no buffer to donate)")
    ap.add_argument("--spec-gamma", default=None,
                    help="self-speculative decoding: draft this many tokens a lane with the "
                         "served tree, verify them in one chunked pass through the masked-dense "
                         "tree ('auto' picks it from the trees' bytes; attention-family archs "
                         "without a window, sync scheduler only)")
    args = ap.parse_args(argv)
    if args.spec_gamma not in (None, "auto"):
        args.spec_gamma = int(args.spec_gamma)
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    if get_config(args.arch).frontend != "none":
        raise SystemExit("serve demo targets token-input archs")
    if (args.prefix_cache or args.kv_int8) and not args.paged:
        raise SystemExit("--prefix-cache/--kv-int8 require --paged")
    if (args.staged_lanes or args.async_stream) and args.max_steps_per_dispatch is None:
        raise SystemExit("--staged-lanes/--async-stream need the device scheduler: pass "
                         "--max-steps-per-dispatch")
    mesh_shape = tuple(int(v) for v in args.mesh.split(",")) if args.mesh else None
    if mesh_shape is not None and (len(mesh_shape) != 2 or min(mesh_shape) < 1):
        raise SystemExit(f"--mesh {args.mesh}: give 'data,model', two axes of at least 1")
    if (mesh_shape is not None and mesh_shape != (1, 1)
            and (args.prefill_chunk is not None or args.prefix_cache
                 or args.spec_gamma is not None)):
        raise NotImplementedError("--prefill-chunk, --prefix-cache and --spec-gamma over a "
                                  "model axis or a data axis > 1 are not ported yet (the rest of "
                                  "tensor parallelism, ROADMAP.md)")
    device = resolve_device(args.device)
    cfg, serving_tree, rep, verifier = build_serving_state(args, device)
    print(json.dumps({"compression": rep}))

    max_len = args.prompt_len + args.gen + 1
    num_pages = args.num_pages
    if args.paged and num_pages is None:
        num_pages = args.batch * (-(-max_len // args.page_size))
    buckets = ([int(b) for b in args.prefill_buckets.split(",")]
               if args.prefill_buckets else None)
    engine_kw = dict(
        max_batch=args.batch, max_len=max_len, seed=0,
        num_pages=num_pages if args.paged else None, page_size=args.page_size,
        steps_per_dispatch=args.steps_per_dispatch,
        max_steps_per_dispatch=args.max_steps_per_dispatch,
        staged_lanes=args.staged_lanes, async_stream=args.async_stream, kv_quant=args.kv_int8,
        prefill_buckets=buckets, kv_shard=args.kv_shard, prefill_chunk=args.prefill_chunk,
        prefix_cache=args.prefix_cache, spec_gamma=args.spec_gamma, verify_params=verifier,
    )
    sampling = dict(temperature=args.temperature, top_k=args.top_k, max_new_tokens=args.gen)
    n_requests = args.batch if args.requests is None else args.requests
    shared = []
    if args.shared_prefix:
        shared = np.random.default_rng(999).integers(
            0, cfg.vocab, min(args.shared_prefix, args.prompt_len - 1)).tolist()
    prompts = [shared + np.random.default_rng(1000 + r).integers(
        0, cfg.vocab, args.prompt_len - len(shared)).tolist() for r in range(n_requests)]
    if mesh_shape is None or mesh_shape == (1, 1):
        mesh = make_local_mesh(1, 1, device=device) if mesh_shape else None
        ranks = serve_rank(mesh, serving_tree, cfg, [{}], prompts, sampling, engine_kw,
                           device=str(device))
    else:
        ranks = [r[0] for r in run_ranks(
            serve_rank, (cfg, [{}], prompts, sampling, engine_kw), model=mesh_shape[1],
            data=mesh_shape[0], device=str(device), tree=serving_tree)]
    summary = make_summary(cfg, ranks[0], rep, args)
    if mesh_shape is not None:
        summary["per_rank"] = [{"rank": i, "weight_bytes": r["stats"]["weight_bytes_per_step"],
                                "kv_cache_bytes": r["stats"]["kv_cache_bytes"]}
                               for i, r in enumerate(ranks)]
    print(json.dumps({"summary": summary}))
    return summary


def serve_rank(mesh, tree: dict, cfg, runs: list, prompts: list, sampling: dict,
               engine_kw: dict, device: str = "cuda") -> list:
    """Serve ``prompts`` once per entry of ``runs`` (engine keywords over
    ``engine_kw``, and optionally its own ``prompts`` and ``sampling``
    keywords over ``sampling``), each on a fresh ``DecodeEngine`` over
    ``tree``; with a
    ``mesh`` this is one rank's part, the function ``launch.mesh.run_ranks``
    runs on every rank.  Returns per run: the results by uid, ``stats()``,
    ``kernel_route()``, each kernel's launches counted from the run's
    start (and K1's by body, ``dispatch.routes``), a digest of the host
    page tables after every scheduling step, a digest of one full
    forward's logits of the first prompt (after the
    launches are read; with ``logits=True`` in the run, those logits too,
    f32 on the CPU), each compressed leaf's model-axis shards as the
    engine holds it (``(rshards, oshards)`` by name), the shape of every
    leaf of its cache by name, and the run's wall seconds."""
    out = []
    for run in runs:
        run = dict(run)
        run_prompts = run.pop("prompts", prompts)
        want_logits = run.pop("logits", False)
        sp = SamplingParams(**{**sampling, **run.pop("sampling", {})})
        eng = DecodeEngine(cfg, tree, mesh=mesh, device=mesh.device if mesh else device,
                           **{**engine_kw, **run})
        for p in run_prompts:
            eng.submit(p, sp)
        tables = hashlib.sha256()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        results = {}
        while eng.queue or any(s is not None for s in eng.slots):
            for r in eng.step():
                results[r.uid] = r
            if eng.pool is not None:
                for key in sorted(eng.pool._pt):
                    tables.update(eng.pool._pt[key].tobytes())
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, routes = dict(dispatch.launches), dict(dispatch.routes)
        with eng._mesh_ctx():
            logits, _ = forward(eng.params, cfg, torch.tensor([run_prompts[0]],
                                                              device=eng.device))
        lg = logits.float().cpu().numpy()
        out.append({"results": results, "stats": eng.stats(), "kernel_route": eng.kernel_route(),
                    "launches": launches, "routes": routes, "tables_digest": tables.hexdigest(),
                    "logits_digest": hashlib.sha256(lg.tobytes()).hexdigest(),
                    "logits": lg if want_logits else None,
                    "shards": {name: (x.rshards, x.oshards) for name, x in tree_items(eng.params)
                               if isinstance(x, CompressedTensor)},
                    "cache_shapes": {name: tuple(x.shape) for name, x in tree_items(eng.cache)},
                    "wall_s": wall})
        del eng
    return out


def step_recipe(nm: str):
    """The STEP recipe whose export serves an ``"n:m"`` pattern."""
    n, m = (int(x) for x in nm.split(":"))
    return core.make_recipe("step", core.SparsityConfig(default=core.NMSparsity(n, m)))


def export_tree(cfg, device, nm: str = "2:4", seed: int = 0) -> dict:
    """The compressed serving tree of ``cfg`` as the CLI makes it without a
    checkpoint: random weights from ``seed``, the STEP ``nm`` export,
    compressed leaf by leaf (the same bits wherever it runs on the same
    kind of device)."""
    return export_compressed(init_params(cfg, seed=seed, device=device), step_recipe(nm))[0]


def f32_twin(cfg, tree: dict) -> tuple:
    """``(cfg, tree)`` with every float leaf (and a compressed leaf's
    values) in f32: the twin the stream gate serves (bf16 widens exactly)."""

    def leaf(_, x):
        if isinstance(x, CompressedTensor):
            return dataclasses.replace(x, values=x.values.float())
        return x.float() if x.is_floating_point() else x

    return (dataclasses.replace(cfg, param_dtype="float32"), tree_map_with_name(leaf, tree))


def serve_jobs(mesh, trees: Optional[dict], jobs: list, device: str = "cuda") -> list:
    """:func:`serve_rank` over several trees in one process, so that one
    spawn of the ranks serves several archs.  A job is a dict of ``cfg``,
    the tree (``tree``, a key of ``trees``; or ``export=True``: made here
    by :func:`export_tree` on the rank's device), ``runs``, ``prompts``,
    ``sampling`` and ``engine_kw`` as :func:`serve_rank` takes them, and
    optionally ``twin``: runs served after them on the tree's
    :func:`f32_twin` (of ``twin_cfg`` where given, e.g. another MoE
    capacity).  Returns per job ``{"runs": [...], "twin": [...],
    "export_s": seconds}``."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    out = []
    for job in jobs:
        cfg = job["cfg"]
        t0 = time.perf_counter()
        tree = export_tree(cfg, dev) if job.get("export") else trees[job["tree"]]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        args = (job["prompts"], job["sampling"], job["engine_kw"])
        rec = {"export_s": time.perf_counter() - t0,
               "runs": serve_rank(mesh, tree, cfg, job["runs"], *args, device=str(dev))}
        if job.get("twin"):
            cfg32, tree = f32_twin(job.get("twin_cfg", cfg), tree)
            rec["twin"] = serve_rank(mesh, tree, cfg32, job["twin"], *args, device=str(dev))
        del tree
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out.append(rec)
    return out


def make_summary(cfg, rank: dict, rep: dict, args) -> dict:
    """The reference's summary keys from one :func:`serve_rank` record."""
    st, results = rank["stats"], rank["results"]
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
        "scheduler": st["scheduler"],
        "host_syncs": st["host_syncs"],
        "cycles": st["cycles"],
        "block_fetches": st["block_fetches"],
        "refills": st["refills"],
        "max_steps_per_dispatch": st["max_steps_per_dispatch"],
        "staged_lanes": st["staged_lanes"],
        "async_stream": st["async_stream"],
        "itl_ms_p50": st["itl_ms_p50"],
        "itl_ms_p99": st["itl_ms_p99"],
        "prefill_batches": st["prefill_batches"],
        "prefill_chunks": st["prefill_chunks"],
        "max_concurrency": st["max_concurrency"],
        "preemptions": st["preemptions"],
        "kv_cache_bytes": st["kv_cache_bytes"],
        "hbm_weight_ratio": round(rep["ratio"], 3),
        "mesh": st["mesh"],
        "collectives_per_decode_step": st["collectives_per_decode_step"],
        "collective_ms_per_decode_step": st["collective_ms_per_decode_step"],
        "kernel_route": rank["kernel_route"],
    }
    if args.paged:
        summary.update(
            evicted_pages=st["evicted_pages"], table_full_uploads=st["table_full_uploads"],
            table_row_syncs=st["table_row_syncs"], table_syncs=st["table_syncs"],
            kv_quant=st["kv_quant"], shared_pages=st["shared_pages"],
            cow_copies=st["cow_copies"],
        )
        summary.update({k: st[k] for k in ("prefix_hits", "prefix_hit_tokens",
                                           "prefix_hit_rate", "prefix_indexed_pages",
                                           "prefix_evictions") if k in st})
    if args.spec_gamma is not None:
        summary.update({k: st[k] for k in (
            "spec_gamma", "spec_rounds", "draft_tokens", "verify_tokens",
            "accepted_draft_tokens", "acceptance_rate", "accepted_per_verify",
            "bytes_per_accepted_token")})
    if args.temperature == 0.0:
        summary["greedy_streams"] = [[int(t) for t in results[u].tokens]
                                     for u in sorted(results)]
    return summary


if __name__ == "__main__":
    main()
