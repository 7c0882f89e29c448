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
``--compress-phase2`` raises until ``optim/compression.py`` is ported
(ROADMAP.md).
"""
from __future__ import annotations

import argparse
import json
from types import SimpleNamespace

import torch

from repro_torch import core
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, list_archs
from repro_torch.data import DataIterator, SyntheticLMDataset
from repro_torch.models.model import frontend_dim, init_params, loss_fn
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.utils.device import resolve_device


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
                    help="1-bit EF gradient compression in the mask phase (not ported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    return ap.parse_args(argv)


def build(args, device, log_fn=None) -> SimpleNamespace:
    """The run ``main`` makes: ``cfg``, ``recipe``, ``trainer``, initial
    ``params``, ``batch_fn`` and ``loss`` (``loss(params, batch)``)."""
    cfg = get_config(args.arch, smoke=args.smoke)
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
        checkpointer=ck, log_fn=log_fn or (lambda step, m: None),
    )
    return SimpleNamespace(cfg=cfg, recipe=recipe, trainer=trainer, batch_fn=batch_fn,
                           loss=loss, params=init_params(cfg, seed=args.seed, device=device))


def summarize(run: SimpleNamespace, state, args, device) -> dict:
    """Export Π_T ⊙ w_T, its loss on a held-out batch, and the summary."""
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


if __name__ == "__main__":
    main()
