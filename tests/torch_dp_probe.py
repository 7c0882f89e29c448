"""A rank function for data-parallel training tests (started by
``launch.mesh.run_ranks`` on every rank; it imports only ``torch`` and the
port): STEP on ``SyntheticTask`` with 1-bit error feedback in phase 2,
through the port's ``Trainer(mesh=)``, recording what each step's
gradient path saw: the rank's own gradient and residual going into
``ef_sign_compress``, and the averaged gradient out of
``mean_over_data``."""
import numpy as np

from repro_torch import core
from repro_torch.data import DataIterator, SyntheticTask
from repro_torch.launch.train import params_digest
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import loop
from repro_torch.utils.tree import tree_items

# the run: 8 steps of a global batch of 8 rows, the switch forced at
# t_max + 1 = 5 (AutoSwitch's window of 10 is not full by then)
TASK = dict(in_dim=32, out_dim=16, hidden=64, seed=0)
STEPS, BATCH, LR = 8, 8, 1e-2
SWITCH = dict(eps=1e-12, window=10, t_min=2, t_max=4)


def flat(tree) -> dict:
    return {n: t.detach().float().cpu().numpy().copy() for n, t in tree_items(tree)}


def build(mesh=None, device="cpu", steps=STEPS, ckpt=None):
    """``(trainer, initial params, task)`` of the run."""
    task = SyntheticTask(**TASK, device=device)
    recipe = core.make_recipe("step", core.SparsityConfig(default=core.NMSparsity(2, 4)))
    scfg = core.StepConfig(learning_rate=LR, b2=0.98,
                           autoswitch=core.AutoSwitchConfig(**SWITCH))

    def batch_fn(step, bs):
        x, y = task.batch(step, bs)
        return {"x": x, "y": y}

    def loss(p, b):
        return task.loss(p, b["x"], b["y"]), {}

    data = DataIterator(batch_fn=batch_fn, batch_size=BATCH, prefetch=0)
    trainer = Trainer(loss, recipe, scfg, data,
                      TrainerConfig(total_steps=steps, log_every=1, ckpt_every=3 if ckpt else 0,
                                    compress_phase2=True),
                      checkpointer=ckpt, mesh=mesh)
    return trainer, task.student_init(0), task


def train_task(mesh, tree, steps=STEPS) -> dict:
    """One rank's run; returns per step its own gradient, the residual it
    held and the phase flag going into the compression, and the averaged
    gradient, and at the end the parameters, their digest and ``t0``."""
    rec = {"local": [], "residual": [], "enabled": [], "avg": []}
    compress, mean = loop.ef_sign_compress, loop.mean_over_data

    def compress_seen(grads, state, enabled):
        rec["local"].append(flat(grads))
        rec["residual"].append(flat(state.residual))
        rec["enabled"].append(bool(enabled))
        return compress(grads, state, enabled)

    def mean_seen(grads, loss, m):
        out = mean(grads, loss, m)
        rec["avg"].append(flat(out[0]))
        return out

    loop.ef_sign_compress, loop.mean_over_data = compress_seen, mean_seen
    try:
        trainer, params, _ = build(mesh, steps=steps)
        state, history = trainer.run(params)
    finally:
        loop.ef_sign_compress, loop.mean_over_data = compress, mean
    return dict(rec, params=flat(state.params), digest=params_digest(state.params),
                t0=int(state.opt.t0), phase2=bool(state.opt.phase2),
                history=[{k: float(v) for k, v in m.items() if np.ndim(v) == 0}
                         for m in history])

