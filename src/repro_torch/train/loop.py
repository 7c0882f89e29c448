"""The training loop: recipe + STEP optimizer + model, with checkpoints
(counterpart of ``repro/train/loop.py``).

``make_train_step`` builds one step of the paper's Algorithm 1:

    masks  = recipe.masks_for_step(params, phase2)      # Π_t (phase 2 only for STEP)
    grads  = ∇ loss(Π_t ⊙ w; ζ_t)                        # STE forward
    grads += λ(1-Π_t)⊙w                                  # SR-STE (if recipe)
    grads  = mean_over_data(compress(grads))             # DP (+1-bit in p2)
    grads *= min(1, clip / ‖grads‖)                     # global-norm clip
    updates, opt = step_optimizer.update(grads, ...)     # 2-phase Adam + AutoSwitch
    params += updates                                    # in place

The phase flag is a host value (``core/step_optimizer.py``): a step reads
it before computing any mask, which is where the reference's ``lax.cond``
sits.  Masks are computed from the parameters *before* the update, with
the flag *entering* the step, so the first masked step is ``t0 + 1``.

Data parallelism (``mesh=``, a ``launch.mesh.Mesh`` rank's view with a
data axis > 1; the reference's ``axis_name``): each rank computes the
gradient of its rows of the batch, compresses it with its own residual
in phase 2 (``compress_phase2``: 1-bit error-feedback signs,
``optim/compression.py``), and the gradients and the loss are averaged
over the data group in one f32 all-reduce a step (:func:`mean_over_data`);
the clip and the optimizer then run on identical values on every rank,
so the parameters and the host's phase flag stay identical without any
other collective.  The state is whole on every rank (no FSDP).

:class:`Trainer` wraps the loop with checkpoint/auto-resume, logging and a
straggler flag.  A checkpoint taken after ``k`` steps is named and labelled
``k``, so a resume runs exactly the steps that remain.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.recipes import Recipe, RecipeState
from repro_torch.core.step_optimizer import StepConfig, step_optimizer
from repro_torch.data.pipeline import DataIterator, IteratorState
from repro_torch.distributed.sharding import batch_pspecs, sanitize_spec
from repro_torch.optim.base import GradientTransformation, apply_updates
from repro_torch.optim.compression import (
    CompressionState,
    ef_sign_compress,
    init_compression_state,
)
from repro_torch.utils.tree import global_norm, tree_items, tree_leaves, tree_map_with_name


class TrainState(NamedTuple):
    params: dict
    opt: Any  # StepState (or any GradientTransformation state)
    recipe: RecipeState
    data_state: np.ndarray  # (2,) int32: (seed, step) mirror of the iterator
    comp: Optional[CompressionState] = None  # EF residual (compress_phase2)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 1000
    log_every: int = 50
    ckpt_every: int = 200
    grad_clip: Optional[float] = 1.0
    compress_phase2: bool = False  # 1-bit EF gradient compression in phase 2


def compute_grads(loss_fn: Callable, recipe: Recipe, params: dict, batch: dict,
                  masks: dict, active: bool) -> tuple[torch.Tensor, dict, dict]:
    """``(loss, metrics, grads)`` of ``loss_fn`` at the recipe's forward
    weights; ``grads`` has ``params``' structure and types."""
    leaves = tree_map_with_name(lambda _, p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(recipe.forward_params(leaves, masks, active), batch)
        flat = list(tree_items(leaves))
        gs = torch.autograd.grad(loss, [p for _, p in flat], allow_unused=True)
    by_name = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(flat, gs)}
    metrics = {k: v.detach() for k, v in metrics.items()}  # free the graph
    return loss.detach(), metrics, tree_map_with_name(lambda n, _: by_name[n], params)


def mean_over_data(grads: dict, loss: torch.Tensor, mesh) -> tuple[dict, torch.Tensor, dict]:
    """``grads`` and ``loss`` averaged over the mesh's data group, in one
    all-reduce of one flat f32 buffer (a ``gloo`` collective has a fixed
    cost of milliseconds on a card); each leaf comes back in its own type
    (bf16 gradients are summed in f32, then cast).  Identical on every rank.
    Returns ``(grads, loss, record)``: the bytes all-reduced and the host
    seconds inside the collective."""
    import torch.distributed as dist

    items = list(tree_items(grads))
    flat = torch.cat([g.reshape(-1).float() for _, g in items] + [loss.reshape(1).float()])
    if flat.is_cuda:
        torch.cuda.synchronize(flat.device)
    t0 = time.perf_counter()
    dist.all_reduce(flat, group=mesh.data_group)
    if flat.is_cuda:
        torch.cuda.synchronize(flat.device)
    rec = {"allreduce_s": time.perf_counter() - t0, "allreduce_bytes": flat.numel() * 4}
    flat = flat / mesh.data
    out, at = {}, 0
    for name, g in items:
        out[name] = flat[at:at + g.numel()].reshape(g.shape).to(g.dtype)
        at += g.numel()
    return (tree_map_with_name(lambda n, _: out[n], grads), flat[at].to(loss.dtype), rec)


def make_train_step(loss_fn: Callable, recipe: Recipe, opt: GradientTransformation, *,
                    grad_clip: Optional[float] = 1.0,
                    compress_phase2: bool = False, mesh=None) -> Callable:
    """The train step ``(state, batch) -> (state, metrics)``.
    ``loss_fn(params, batch) -> (loss, metrics)``; the recipe decides what
    the model sees.  Parameters and optimizer moments advance in place.
    With ``mesh`` (a data axis > 1) ``batch`` is this rank's rows and the
    gradients are averaged over the data group (module docstring); the
    metrics gain the all-reduce's bytes and seconds."""
    data_parallel = mesh is not None and mesh.data > 1

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        phase2 = bool(getattr(state.opt, "phase2", False))
        masks, active, rstate = recipe.masks_for_step(state.params, state.recipe, phase2)
        loss, metrics, grads = compute_grads(loss_fn, recipe, state.params, batch,
                                             masks, active)
        grads = recipe.grad_postprocess(grads, state.params, masks, active)
        del masks
        comp = state.comp
        if compress_phase2 and comp is not None:
            grads, comp = ef_sign_compress(grads, comp, phase2)
        reduced = {}
        if data_parallel:
            grads, loss, reduced = mean_over_data(grads, loss, mesh)
        gnorm = global_norm(grads)
        if grad_clip is not None:
            # f32, as the reference's bf16 gradient times its f32 scale
            scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
            grads = tree_map_with_name(lambda _, g: g.float() * scale, grads)
        updates, ostate = opt.update(grads, state.opt, state.params)
        del grads
        apply_updates(state.params, updates)
        new_state = TrainState(params=state.params, opt=ostate, recipe=rstate,
                               data_state=state.data_state + np.array([0, 1], np.int32),
                               comp=comp)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, phase2=int(phase2),
                       mask_active=int(active), **reduced)
        if compress_phase2 and comp is not None:
            metrics["ef_residual_norm"] = global_norm(comp.residual)
        if hasattr(ostate, "z_bar"):
            metrics["z_bar"] = ostate.z_bar
            metrics["t0"] = ostate.t0
        return new_state, metrics

    return step


def rank_rows(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch: each leaf's leading dim split over
    the data axis as ``sharding.batch_pspecs`` places it (whole where the
    rows do not divide, as the sanitized placement holds it)."""
    if mesh is None or mesh.data == 1:
        return batch
    specs = batch_pspecs(mesh, batch)

    def rows(name, x):
        spec = sanitize_spec(_at(specs, name), tuple(x.shape), mesh)
        if spec[0] is None:
            return x
        per = x.shape[0] // mesh.data
        return x[mesh.data_index * per:(mesh.data_index + 1) * per]

    return tree_map_with_name(rows, batch)


def _at(tree: dict, name: str):
    for key in name.split("/"):
        tree = tree[key]
    return tree


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


@dataclasses.dataclass
class Trainer:
    """Checkpointing, auto-resuming driver around ``make_train_step``."""

    loss_fn: Callable[..., tuple[torch.Tensor, dict]]
    recipe: Recipe
    step_cfg: StepConfig
    data: DataIterator
    cfg: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    checkpointer: Optional[Checkpointer] = None
    log_fn: Callable[[int, dict], None] = lambda step, m: None
    mesh: Any = None  # a data axis > 1: data-parallel (module docstring)

    def __post_init__(self):
        self.opt = step_optimizer(self.step_cfg)
        self._step = make_train_step(self.loss_fn, self.recipe, self.opt,
                                     grad_clip=self.cfg.grad_clip,
                                     compress_phase2=self.cfg.compress_phase2, mesh=self.mesh)

    def init_state(self, params: dict) -> TrainState:
        # the step updates parameters in place: copy the caller's
        params = tree_map_with_name(lambda _, p: p.detach().clone(), params)
        return TrainState(
            params=params, opt=self.opt.init(params),
            recipe=self.recipe.init_state(params),
            data_state=np.array([self.data.state.seed, self.data.state.step], np.int32),
            comp=init_compression_state(params) if self.cfg.compress_phase2 else None,
        )

    def restore_or_init(self, params: dict) -> tuple[TrainState, int]:
        """A fresh state, or the newest verified checkpoint read into it;
        returns ``(state, steps already done)`` and resynchronizes the data
        stream."""
        state, start = self.init_state(params), 0
        if self.checkpointer is not None:
            latest = self.checkpointer.latest_step()
            if latest is not None:
                state, meta = self.checkpointer.load(state, latest)
                start = int(meta.get("step", latest))
                seed, step = (int(x) for x in state.data_state)
                self.data.set_state(IteratorState(seed, step))
        return state, start

    def run(self, params: dict,
            step_timeout: Optional[float] = None) -> tuple[TrainState, list[dict]]:
        """Train until ``total_steps``, checkpointing and auto-resuming.

        ``step_timeout``: straggler deadline in seconds; a logged step that
        exceeds it carries ``straggler: True`` (the signal a cluster
        launcher uses to evict a slow host and restart from the last
        checkpoint).  A logged step's time ends in a device sync.  On a
        mesh each rank takes its rows of every global batch
        (:func:`rank_rows`)."""
        state, start = self.restore_or_init(params)
        device = tree_leaves(state.params)[0].device
        history: list[dict] = []
        total, ck = self.cfg.total_steps, self.checkpointer
        for step in range(start, total):
            batch = _to_device(rank_rows(next(self.data), self.mesh), device)
            t0 = time.perf_counter()
            state, metrics = self._step(state, batch)
            if self.cfg.log_every and step % self.cfg.log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}  # host sync
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                metrics["step"] = step
                metrics["step_time_s"] = dt = time.perf_counter() - t0
                if step_timeout and dt > step_timeout:
                    metrics["straggler"] = True
                history.append(metrics)
                self.log_fn(step, metrics)
            done = step + 1
            if ck is not None and self.cfg.ckpt_every and done % self.cfg.ckpt_every == 0 \
                    and done < total:
                ck.save(done, state)
        if ck is not None:
            ck.save(total, state)
        return state, history
