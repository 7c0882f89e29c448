"""Training launcher: STEP N:M mask learning on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --no-smoke --recipe step \\
        --steps 300 --batch 8 --seq 128 --ckpt-dir RUN [--device cpu]

Counterpart of ``repro/launch/train.py`` on one device: the synthetic
Markov corpus, the recipe, the STEP optimizer with AutoSwitch, checkpoints
with auto-resume (``--ckpt-dir``), then the final N:M export and its loss.
Every mask, per step and at export, runs the ``nm_mask`` kernel on the
card.  Prints a JSON line per logged step and a summary line with the
reference's keys.  ``repro_torch.launch.serve --ckpt-dir RUN`` serves the
result.  ``--arch`` takes every arch of ``configs.list_archs()``.  An arch
with a stub frontend (qwen2-vl-2b, musicgen-large) trains as the
reference's does: each batch carries the corpus's ``labels`` and, in
place of its tokens, bf16 ``embeds`` (batch, seq, ``frontend_dim``) drawn
on the device from a generator seeded with the step.
``--compress-phase2`` compresses the gradient to 1-bit error-feedback
signs in phase 2 (``optim/compression.py``), as the reference's does; on
one process there is no all-reduce to shrink, so it changes only the
numbers the optimizer sees.

Data-parallel training has no CLI flag, as the reference's CLI has none:
:func:`train_rank` is one rank of it, started on every rank of a
``(data, 1)`` mesh by ``launch.mesh.run_ranks`` (e.g.
``run_ranks(train_rank, (argv,), data=2, model=1)``, ``gloo`` where the
ranks share a card or run on the CPU).  It builds the trainer as the CLI
does from the same ``argv`` and trains each rank on its rows of every
global batch, the gradients averaged over the data group.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from repro_torch import core
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, list_archs
from repro_torch.data import DataIterator, SyntheticLMDataset
from repro_torch.kernels import dispatch
from repro_torch.models.model import frontend_dim, init_params, loss_fn
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.loop import compute_grads, mean_over_data, rank_rows
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_items, tree_map_with_name


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-paper", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config; --no-smoke for the full config")
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--recipe", default="step", choices=list(core.RECIPES))
    ap.add_argument("--nm", default="2:4")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--b2", type=float, default=0.98)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--compress-phase2", action="store_true",
                    help="1-bit EF gradient compression in the mask phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    return ap.parse_args(argv)


def build(args, device, log_fn=None, *, mesh=None, n_layers: Optional[int] = None,
          switch: Optional[tuple] = None) -> SimpleNamespace:
    """The run ``main`` makes: ``cfg``, ``recipe``, ``trainer``, initial
    ``params``, ``batch_fn`` and ``loss`` (``loss(params, batch)``).  With
    ``mesh`` the trainer is data-parallel over it; ``n_layers`` keeps the
    arch's first layers and ``switch`` sets AutoSwitch's ``(t_min,
    t_max)``."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    n, m = (int(x) for x in args.nm.split(":"))
    recipe = core.make_recipe(
        args.recipe, core.SparsityConfig(default=core.NMSparsity(n, m)),
        prune_at=int(0.3 * args.steps), dense_until=int(0.2 * args.steps),
    )
    scfg = core.StepConfig(
        learning_rate=args.lr, b2=args.b2,
        autoswitch=core.AutoSwitchConfig(
            eps=2e-5, window=min(100, int(round(1 / (1 - args.b2)))),
            t_min=int(0.1 * args.steps), t_max=int(0.5 * args.steps),
        ),
    )
    if switch is not None:
        scfg = dataclasses.replace(scfg, autoswitch=dataclasses.replace(
            scfg.autoswitch, t_min=switch[0], t_max=switch[1]))
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=args.seq, seed=42, n_states=16)
    chunk = min(128, args.seq)

    def batch_fn(step, bs):
        batch = ds.batch(step, bs)
        if cfg.frontend != "none":  # stub frontend: frame/patch embeddings for the tokens
            gen = torch.Generator(device=device).manual_seed(step)
            batch["embeds"] = torch.randn((bs, args.seq, frontend_dim(cfg)), generator=gen,
                                          device=device, dtype=torch.bfloat16)
            del batch["tokens"]
        return batch

    def loss(p, batch):
        return loss_fn(p, cfg, batch, chunk=chunk)

    data = DataIterator(batch_fn=batch_fn, batch_size=args.batch, prefetch=2)
    ck = Checkpointer(args.ckpt_dir, keep_last=3) if args.ckpt_dir else None
    trainer = Trainer(
        loss, recipe, scfg, data,
        TrainerConfig(total_steps=args.steps, log_every=max(1, args.steps // 20),
                      ckpt_every=args.ckpt_every if ck else 0,
                      compress_phase2=args.compress_phase2),
        checkpointer=ck, log_fn=log_fn or (lambda step, m: None), mesh=mesh,
    )
    return SimpleNamespace(cfg=cfg, recipe=recipe, trainer=trainer, batch_fn=batch_fn,
                           loss=loss, params=init_params(cfg, seed=args.seed, device=device))


def summarize(run: SimpleNamespace, state, args, device, sparse=None) -> dict:
    """Export Π_T ⊙ w_T (or take the export ``sparse``), its loss on a
    held-out batch, and the summary."""
    if sparse is None:
        sparse = run.recipe.export_sparse(state.params)
    eval_batch = {k: torch.as_tensor(v).to(device)
                  for k, v in run.batch_fn(10**6, args.batch).items()}
    with torch.no_grad():
        final_loss, _ = run.loss(sparse, eval_batch)
    rep = core.sparsity_report(state.params, run.recipe.sparsity)
    return {
        "arch": run.cfg.name,
        "recipe": args.recipe,
        "final_sparse_eval_loss": float(final_loss),
        "phase2": bool(getattr(state.opt, "phase2", False)),
        "t0": int(getattr(state.opt, "t0", 0)),
        "maskable_fraction": round(rep["maskable_fraction"], 3),
        "removed_fraction": round(rep["removed_fraction_of_total"], 3),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)

    def log(step, metrics):
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in metrics.items() if k in (
                              "step", "loss", "ce", "grad_norm", "phase2", "z_bar", "t0",
                              "step_time_s")}), flush=True)

    run = build(args, device, log)
    try:
        state, _ = run.trainer.run(run.params)
    finally:
        run.trainer.data.close()
    summary = summarize(run, state, args, device)
    print(json.dumps({"summary": summary}), flush=True)
    return summary


def params_digest(params: dict) -> str:
    """SHA-256 of every parameter's bytes, in tree order."""
    h = hashlib.sha256()
    for _, p in tree_items(params):
        h.update(p.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def off_pattern(recipe, sparse: dict) -> list:
    """The maskable leaves of an export that break their N:M pattern (a
    group of M holding more than N nonzeros); empty when it is exact."""
    bad = []
    for name, p in tree_items(sparse):
        pat = recipe.sparsity.pattern_for(name, tuple(p.shape))
        if pat is None:
            continue
        nz = (p != 0).movedim(-2, -1).reshape(-1, pat.m).sum(-1)
        if not bool((nz <= pat.n).all()):
            bad.append(name)
    return bad


def probe_grads(run: SimpleNamespace, mesh, device) -> dict:
    """One phase-1 gradient of step 0 in f32, averaged over the data group
    as a step averages it: the initial parameters widened to f32, this
    rank's rows of batch 0.  Returns the flat averaged gradient (numpy f32,
    tree order) and the loss."""
    cfg32 = dataclasses.replace(run.cfg, param_dtype="float32")
    p32 = tree_map_with_name(lambda _, p: p.float(), run.params)
    batch = {k: torch.as_tensor(v).to(device)
             for k, v in rank_rows(run.batch_fn(0, run.trainer.data.batch_size), mesh).items()}
    loss, _, grads = compute_grads(lambda p, b: loss_fn(p, cfg32, b, chunk=run.chunk),
                                   run.recipe, p32, batch, {}, False)
    grads, loss, _ = mean_over_data(grads, loss, mesh)
    flat = torch.cat([g.reshape(-1) for _, g in tree_items(grads)])
    return {"grad": flat.cpu().numpy(), "loss": float(loss)}


def train_rank(mesh, tree, argv: list, opts: Optional[dict] = None) -> dict:
    """One rank of data-parallel training: the trainer the CLI builds from
    ``argv`` (``tree`` is unused: every rank initializes the same weights
    from ``--seed``), on this rank's rows of every global batch of
    ``--batch``.  ``opts``: ``n_layers`` and ``switch`` (``build``'s),
    ``grad_probe`` (return :func:`probe_grads`'s f32 gradient, on rank 0
    in full and as a digest elsewhere).  Returns the summary, the
    logged metrics, the final parameters' digest and phase flag, the kernel
    launches of the training steps and of the export, the exported leaves
    off their N:M pattern (none) and (on a card) the peak device memory."""
    opts = dict(opts or {})
    args = parse_args(argv)
    device = mesh.device
    history: list = []
    run = build(args, device, lambda step, m: history.append(m), mesh=mesh,
                n_layers=opts.get("n_layers"), switch=opts.get("switch"))
    run.chunk = min(128, args.seq)
    out: dict = {"rank": mesh.rank, "data_index": mesh.data_index}
    if opts.get("grad_probe"):
        probe = probe_grads(run, mesh, device)
        digest = hashlib.sha256(probe["grad"].tobytes()).hexdigest()
        out["probe"] = dict(probe, grad=probe["grad"] if mesh.rank == 0 else None,
                            digest=digest)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    dispatch.reset_launches()
    t0 = time.perf_counter()
    try:
        state, _ = run.trainer.run(run.params)
    finally:
        run.trainer.data.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["train_s"] = time.perf_counter() - t0
    out["train_launches"] = dict(dispatch.launches)
    dispatch.reset_launches()
    sparse = run.recipe.export_sparse(state.params)
    out["export_launches"] = dict(dispatch.launches)
    out["export_off_pattern"] = off_pattern(run.recipe, sparse)
    out["summary"] = summarize(run, state, args, device, sparse)
    out["history"] = [{k: float(v) for k, v in m.items() if np.ndim(v) == 0} for m in history]
    out["params_digest"] = params_digest(state.params)
    out["phase2"] = bool(getattr(state.opt, "phase2", False))
    out["t0"] = int(getattr(state.opt, "t0", 0))
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


if __name__ == "__main__":
    main()
