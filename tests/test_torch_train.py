"""The port's training path against the JAX package at the reduced
gpt2-paper size in f32, on JAX-made batches: one and three train steps
(loss, gradient norm, gradients, parameters), a 40-step STEP run through
the switch, kill-and-resume, checkpoints the reference reads, and the
launcher.

Tolerances: the loss and the gradient norm agree to 1e-5 relative and the
gradients to 1e-6 absolute (f32 sums in other orders).  Adam turns a tiny
gradient difference on a near-zero coordinate into a visible step
difference, so parameters are held within a share of the learning rate:
every coordinate within 1e-2·lr and 99.9 % of them within 1e-4·lr after
three steps (measured: 2.4e-3·lr and 4e-5·lr)."""
import dataclasses
import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.checkpoint import load_pytree as jax_load_pytree
from repro.data import DataIterator as JaxDataIterator
from repro.data import SyntheticLMDataset as JaxDataset
from repro.models.model import TransformerLM
from repro.train import Trainer as JaxTrainer
from repro.train.loop import TrainState as JaxTrainState
from repro.train.loop import make_train_step as jax_make_train_step
from repro.utils.tree import tree_paths as jax_tree_paths
from repro_torch import core as tcore
from repro_torch.checkpoint import Checkpointer, carry_over
from repro_torch.configs import get_config
from repro_torch.data import DataIterator, SyntheticLMDataset
from repro_torch.launch import train as launch_train
from repro_torch.models.model import init_params, loss_fn
from repro_torch.train import Trainer, TrainerConfig, TrainState, make_train_step
from repro_torch.train.loop import compute_grads
from repro_torch.utils.tree import tree_flatten_named, tree_items
from torch_parity import configs, to_numpy

LR, SEQ, BATCH, STEPS = 3e-3, 32, 4, 40
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-6


def _cfgs(core, **asw):
    asw = dict(dict(eps=2e-5, window=10, t_min=4, t_max=20), **asw)
    return (core.make_recipe("step", core.SparsityConfig(default=core.NMSparsity(2, 4))),
            core.StepConfig(learning_rate=LR, b2=0.98, autoswitch=core.AutoSwitchConfig(**asw)))


@pytest.fixture(scope="module")
def runs():
    """40 steps of JAX's and the port's train step from the same weights on
    the same JAX-made batches: per-step metrics and the parameters after
    steps 1 and 3."""
    jcfg, tcfg = configs()
    model = TransformerLM(jcfg)
    pj = model.init(jax.random.PRNGKey(0))
    ds = JaxDataset(vocab=jcfg.vocab, seq_len=SEQ, seed=42, n_states=16)
    big = {k: np.asarray(v) for k, v in ds.batch(0, BATCH * STEPS).items()}  # one trace
    batches = [{k: v[s * BATCH:(s + 1) * BATCH] for k, v in big.items()} for s in range(STEPS)]
    (jr, jsc), (tr, tsc) = _cfgs(jcore), _cfgs(tcore)
    jopt, topt = jcore.step_optimizer(jsc), tcore.step_optimizer(tsc)
    jstep = jax.jit(jax_make_train_step(lambda p, b: model.loss(p, b, chunk=SEQ), jr, jopt))
    tstep = make_train_step(lambda p, b: loss_fn(p, tcfg, b, chunk=SEQ), tr, topt)
    pt = carry_over(to_numpy(pj), device="cpu")
    js = JaxTrainState(pj, jopt.init(pj), jr.init_state(pj), None, jax.random.PRNGKey(0),
                       jnp.zeros((2,), jnp.int32))
    ts = TrainState(pt, topt.init(pt), tr.init_state(pt), np.zeros((2,), np.int32))
    out = {"jax": [], "port": [], "params": {}, "batches": batches, "pj": pj, "tcfg": tcfg,
           "model": model}
    for s in range(STEPS):
        js, jm = jstep(js, batches[s])
        ts, tm = tstep(ts, {k: torch.from_numpy(np.array(v)) for k, v in batches[s].items()})
        out["jax"].append({k: float(v) for k, v in jm.items()})
        out["port"].append({k: float(v) for k, v in tm.items()})
        if s + 1 in (1, 3):
            out["params"][s + 1] = (to_numpy(js.params),
                                    {n: p.numpy().copy() for n, p in tree_items(ts.params)})
    out["final"] = (js, ts)
    return out


def test_first_step_loss_grad_norm_and_gradients(runs):
    j, t = runs["jax"][0], runs["port"][0]
    for k in ("loss", "ce", "zloss", "grad_norm"):
        np.testing.assert_allclose(t[k], j[k], rtol=LOSS_RTOL, err_msg=k)
    model, b = runs["model"], runs["batches"][0]
    jgrad = jax.jit(jax.grad(lambda p: model.loss(p, b, chunk=SEQ)[0]))(runs["pj"])
    recipe, _ = _cfgs(tcore)
    pt = carry_over(to_numpy(runs["pj"]), device="cpu")
    loss, _, tgrad = compute_grads(
        lambda p, bb: loss_fn(p, runs["tcfg"], bb, chunk=SEQ), recipe, pt,
        {k: torch.from_numpy(np.array(v)) for k, v in b.items()}, {}, False)
    np.testing.assert_allclose(float(loss), j["loss"], rtol=LOSS_RTOL)
    jf = dict(tree_items(to_numpy(jgrad)))
    for name, g in tree_items(tgrad):
        np.testing.assert_allclose(g.numpy(), jf[name], atol=GRAD_ATOL, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("after", [1, 3])
def test_parameters_after_steps_within_a_share_of_lr(after, runs):
    jp, tp = runs["params"][after]
    diffs = np.concatenate([np.abs(tp[n] - a).ravel() for n, a in tree_items(jp)])
    assert diffs.max() <= 1e-2 * LR, diffs.max() / LR
    assert np.quantile(diffs, 0.999) <= 1e-4 * LR, np.quantile(diffs, 0.999) / LR


def test_forty_step_run_switches_where_the_reference_does(runs):
    """The window (T_w = 10) fills at step 10 with its mean far below eps
    (1e-7 against 2e-5), so both switch there; the losses agree until
    phase-2 masks start to differ at near-ties of |w| (after step 30 here),
    and fall."""
    jt = [(int(m["phase2"]), int(m["t0"])) for m in runs["jax"]]
    tt = [(int(m["phase2"]), int(m["t0"])) for m in runs["port"]]
    assert tt == jt
    assert tt[9] == (0, 10) and tt[10] == (1, 10)
    js, ts = runs["final"]
    assert ts.opt.phase2 and ts.opt.t0 == int(js.opt.t0) == 10
    for s, (j, t) in enumerate(zip(runs["jax"][:30], runs["port"][:30])):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4, err_msg=f"step {s}")
    # masks run from the step after the switch: t = t0 + 1 = 11, index 10
    assert [m["mask_active"] for m in runs["port"]] == [0] * 10 + [1] * 30
    losses = [m["loss"] for m in runs["port"]]
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 1.0
    sparse = tcore.make_recipe("step").final_masks(ts.params)
    for name, mk in tree_items(sparse):
        if "attn/w" in name or "mlp/w" in name:
            assert (mk.reshape(mk.shape[0], -1, 4, mk.shape[-1]).sum(2) == 2).all(), name


def _trainer(ckpt_dir, total, ckpt_every, crash_at=None, dtype="float32"):
    cfg = dataclasses.replace(get_config("gpt2-paper", smoke=True), param_dtype=dtype)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=16, seed=42, n_states=16)

    def batch_fn(step, bs):
        if step == crash_at:
            raise KeyboardInterrupt("killed")
        return ds.batch(step, bs)

    recipe, scfg = _cfgs(tcore, eps=1e-30, window=3, t_min=None, t_max=5)
    return cfg, Trainer(
        lambda p, b: loss_fn(p, cfg, b, chunk=16), recipe, scfg,
        DataIterator(batch_fn=batch_fn, batch_size=2, prefetch=0),
        TrainerConfig(total_steps=total, log_every=0, ckpt_every=ckpt_every),
        checkpointer=Checkpointer(str(ckpt_dir), keep_last=3) if ckpt_dir else None)


def _flat_state(state):
    return {n: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for n, v in tree_flatten_named(state)}


def test_kill_and_resume_is_bit_exact(tmp_path):
    """Killed after the step-4 checkpoint, a rerun resumes at step 4 and ends
    where an uninterrupted run ends, bit for bit, through the switch
    (t_max = 5: t0 = 6)."""
    cfg, tr = _trainer(tmp_path / "a", 12, 4)
    params = init_params(cfg, seed=3, device="cpu")
    full, _ = tr.run(params)
    _, tr1 = _trainer(tmp_path / "b", 12, 4, crash_at=6)
    with pytest.raises(KeyboardInterrupt):
        tr1.run(params)
    assert Checkpointer(str(tmp_path / "b")).steps() == [4]
    _, tr2 = _trainer(tmp_path / "b", 12, 4)
    _, start = tr2.restore_or_init(params)
    assert start == 4 and tr2.data.state.step == 4
    resumed, _ = tr2.run(params)
    assert resumed.opt.t0 == full.opt.t0 == 6 and resumed.opt.step == 12
    a, b = _flat_state(full), _flat_state(resumed)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_checkpoint_names_match_and_jax_reads_the_params(tmp_path):
    """A bf16 port checkpoint carries the reference TrainState's leaf names
    (but its PRNG key) and JAX's load_pytree reads its params bit-exact."""
    cfg, tr = _trainer(tmp_path, 2, 0, dtype="bfloat16")
    state, _ = tr.run(init_params(cfg, seed=1, device="cpu"))
    path = Checkpointer(str(tmp_path)).step_dir(2)
    jcfg = dataclasses.replace(configs()[0], param_dtype="bfloat16")
    like = TransformerLM(jcfg).init(jax.random.PRNGKey(0))
    jr, jsc = _cfgs(jcore, eps=1e-30, window=3, t_min=None, t_max=5)
    jtr = JaxTrainer(lambda p, b: (0.0, {}), jr, jsc,
                     JaxDataIterator(batch_fn=lambda s, b: None, batch_size=1, prefetch=0))
    jax_names = set(jax_tree_paths(jtr.init_state(like))) - {"rng"}
    with open(os.path.join(path, "manifest.json")) as f:
        keys = {k.replace("::bf16", "") for k in json.load(f)["keys"]}
    assert keys == jax_names
    got, meta = jax_load_pytree(path, {"params": like})
    assert meta["step"] == 2
    jf = dict(tree_items(to_numpy(got["params"])))
    for name, p in tree_items(state.params):
        assert p.dtype == (torch.float32 if "norm" in name else torch.bfloat16), name
        bits = p.view(torch.int16 if p.dtype == torch.bfloat16 else torch.int32).numpy()
        np.testing.assert_array_equal(bits, jf[name].view(bits.dtype), err_msg=name)


def test_launcher_trains_switches_and_summarizes(tmp_path):
    buf = io.StringIO()
    with redirect_stdout(buf):
        summary = launch_train.main(["--device", "cpu", "--steps", "8", "--batch", "2",
                                     "--seq", "16", "--ckpt-dir", str(tmp_path)])
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert last == {"summary": summary}
    assert summary["phase2"] and summary["t0"] == 5  # t_max = 0.5 * 8
    assert np.isfinite(summary["final_sparse_eval_loss"])
    assert summary["maskable_fraction"] > 0.8 and summary["removed_fraction"] > 0.4
    assert Checkpointer(str(tmp_path)).steps() == [8]
    buf = io.StringIO()
    with redirect_stdout(buf):  # 1-bit error feedback from the switch on
        comp = launch_train.main(["--device", "cpu", "--steps", "8", "--batch", "2",
                                  "--seq", "16", "--compress-phase2"])
    assert comp["phase2"] and comp["t0"] == 5
    assert np.isfinite(comp["final_sparse_eval_loss"])
    assert comp["final_sparse_eval_loss"] != summary["final_sparse_eval_loss"]
    logged = [json.loads(line) for line in buf.getvalue().strip().splitlines()[:-1]]
    assert [m["phase2"] for m in logged] == [0] * 5 + [1] * 3
