"""1-bit error-feedback gradient compression (``optim/compression.py``) and
the training placements (``distributed/sharding.py``'s ``batch_pspecs``
and ``state_pspecs``) of the port, held against the JAX package.

- ``ef_sign_compress`` against the reference's, leaf by leaf within 1e-6
  of the leaf's magnitude, over five error-feedback steps: f32 and bf16 gradients of a tree with a
  stacked ``body/`` leaf (one scale spans its layers), an all-zero leaf,
  and phase 1 (``enabled=False``: the gradient passes as f32, the residual
  stays).
- The port's ``Trainer`` with ``compress_phase2`` against the reference's
  on the reduced gpt2-paper in f32, over steps around a switch forced at
  step 3: losses, gradient norms and residuals within the tolerances of
  ``test_torch_train``'s step parity, parameters within 1e-2·lr plus a
  share of their own movement; the residual is zero before the switch
  and nonzero after.
- Kill-and-resume with the residual in the checkpoint is bit-exact.
- Placements of a ``TrainState`` that carries the residual, and of a
  batch, equal the reference's at (2, 1), (2, 2) and (4, 2) stand-in
  meshes, FSDP on and off."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import repro.core as jcore
from repro.data import DataIterator as JaxDataIterator
from repro.distributed.sharding import batch_pspecs as jax_batch_pspecs
from repro.distributed.sharding import state_pspecs as jax_state_pspecs
from repro.models.model import TransformerLM
from repro.optim.compression import compressed_bits_per_element as jax_bits
from repro.optim.compression import ef_sign_compress as jax_ef_sign_compress
from repro.optim.compression import init_compression_state as jax_init_compression
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro.utils.tree import _path_str
from repro_torch import core as tcore
from repro_torch.checkpoint import Checkpointer, carry_over
from repro_torch.data import DataIterator
from repro_torch.distributed.sharding import batch_pspecs, state_pspecs
from repro_torch.models.model import loss_fn
from repro_torch.optim.compression import (
    compressed_bits_per_element,
    ef_sign_compress,
    init_compression_state,
)
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.utils.tree import tree_flatten_named, tree_items
from torch_dp_probe import build
from torch_parity import configs, to_numpy

# the training run of the Trainer parity (test_torch_train's shapes)
LR, SEQ, BATCH, STEPS = 3e-3, 32, 4, 6
SWITCH = dict(eps=1e-30, window=10, t_min=1, t_max=2)  # forced at t_max + 1 = 3


def _tree(rng, dtype):
    """A gradient-shaped tree: a stacked body leaf, an embedding, a norm
    vector and an all-zero leaf."""
    shapes = {"body/sb_0/attn/wq": (3, 16, 8), "tok_embed": (32, 16),
              "final_norm/scale": (16,), "zero/w": (4, 4)}
    flat = {}
    for name, shape in shapes.items():
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        flat[name] = (x * 0 if name.startswith("zero") else x).to(dtype)
    out = {}
    for name, x in flat.items():
        node = out
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = x
    return out


def _jax(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree,
        is_leaf=lambda t: isinstance(t, torch.Tensor))


@pytest.mark.parametrize("case", ["f32", "bf16", "disabled"])
def test_ef_sign_compress_matches_the_reference(case):
    """Five error-feedback steps of fresh gradients through both packages'
    compressors, each keeping its own residual: the compressed gradients
    and the residuals agree leaf by leaf within 1e-6 of the leaf's largest
    magnitude (the two packages sum ``mean|x|`` in other orders, and the
    residual carries that over the steps); an all-zero leaf
    stays zero; phase 1 passes the gradient as f32 and keeps the
    residual."""
    rng = np.random.default_rng(7)
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    enabled = case != "disabled"
    st = init_compression_state(_tree(rng, dtype))
    jst = jax_init_compression(_jax(_tree(rng, dtype)))
    for _ in range(5):
        g = _tree(rng, dtype)
        q, st = ef_sign_compress(g, st, enabled)
        jq, jst = jax_ef_sign_compress(_jax(g), jst, enabled)
        jflat = dict(tree_items(jax.tree_util.tree_map(np.asarray, jq)))
        rflat = dict(tree_items(jax.tree_util.tree_map(np.asarray, jst.residual)))
        for name, x in tree_items(q):
            assert x.dtype == torch.float32
            for got, ref in ((x, jflat[name]), (tree_items_at(st.residual, name), rflat[name])):
                np.testing.assert_allclose(got.numpy(), ref, rtol=0, err_msg=name,
                                           atol=1e-6 * max(np.abs(ref).max(), 1e-30))
        assert not q["zero"]["w"].any()
        if enabled:
            wq = q["body"]["sb_0"]["attn"]["wq"]
            assert len(set(wq.abs().flatten().tolist())) == 1  # one scale for all layers
        else:
            assert all(not r.any() for _, r in tree_items(st.residual))
            for name, x in tree_items(q):
                np.testing.assert_array_equal(x.numpy(), tree_items_at(g, name).float().numpy())
    assert compressed_bits_per_element() == jax_bits() == 1.0


def tree_items_at(tree, name):
    for key in name.split("/"):
        tree = tree[key]
    return tree


def _batches():
    from repro.data import SyntheticLMDataset as JaxDataset

    jcfg, _ = configs()
    ds = JaxDataset(vocab=jcfg.vocab, seq_len=SEQ, seed=42, n_states=16)
    big = {k: np.asarray(v) for k, v in ds.batch(0, BATCH * STEPS).items()}
    return [{k: v[s * BATCH:(s + 1) * BATCH] for k, v in big.items()} for s in range(STEPS)]


@pytest.fixture(scope="module")
def trainers():
    """Both packages' Trainers with ``compress_phase2``, STEPS steps from the
    same weights on the same JAX-made batches, the switch forced at 3."""
    jcfg, tcfg = configs()
    model = TransformerLM(jcfg)
    pj = model.init(jax.random.PRNGKey(0))
    batches = _batches()
    jr = jcore.make_recipe("step", jcore.SparsityConfig(default=jcore.NMSparsity(2, 4)))
    tr = tcore.make_recipe("step", tcore.SparsityConfig(default=tcore.NMSparsity(2, 4)))
    jsc = jcore.StepConfig(learning_rate=LR, b2=0.98,
                           autoswitch=jcore.AutoSwitchConfig(**SWITCH))
    tsc = tcore.StepConfig(learning_rate=LR, b2=0.98,
                           autoswitch=tcore.AutoSwitchConfig(**SWITCH))
    jtr = JaxTrainer(lambda p, b: model.loss(p, b, chunk=SEQ), jr, jsc,
                     JaxDataIterator(batch_fn=lambda s, b: batches[s], batch_size=BATCH,
                                     prefetch=0),
                     JaxTrainerConfig(total_steps=STEPS, log_every=1, ckpt_every=0,
                                      compress_phase2=True, donate=False))
    ttr = Trainer(lambda p, b: loss_fn(p, tcfg, b, chunk=SEQ), tr, tsc,
                  DataIterator(batch_fn=lambda s, b: batches[s], batch_size=BATCH, prefetch=0),
                  TrainerConfig(total_steps=STEPS, log_every=1, ckpt_every=0,
                                compress_phase2=True))
    p0 = dict(tree_items(to_numpy(pj)))
    js, jh = jtr.run(pj)
    ts, th = ttr.run(carry_over(to_numpy(pj), device="cpu"))
    return js, jh, ts, th, p0


def test_trainer_with_compression_matches_the_reference(trainers):
    """Both switch at 3; the loss and the gradient norm agree step by step to
    1e-5 relative and the residuals (the compressed gradients' carried
    error) to 1e-6 absolute, the step-parity tolerances.  Parameters: a
    compressed step moves a coordinate by ``lr · (1 - b1) · mean|x| / P*``,
    up to hundreds of ``lr`` where the frozen preconditioner is small, so
    each coordinate is held within 1e-2·lr plus 1e-4 of its own movement
    over the run.  ``bias_k`` is left out of that check: its gradient is
    zero in exact arithmetic (a key bias adds one score to every key of a
    query), so under compression each package sends the sign of its own
    rounding noise."""
    js, jh, ts, th, p0 = trainers
    assert [int(m["phase2"]) for m in th] == [int(m["phase2"]) for m in jh] == [0] * 3 + [1] * 3
    assert ts.opt.t0 == int(js.opt.t0) == 3
    for s, (j, t) in enumerate(zip(jh, th)):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=f"{k} at step {s}")
    jres = dict(tree_items(to_numpy(js.comp.residual)))
    for name, r in tree_items(ts.comp.residual):
        np.testing.assert_allclose(r.numpy(), jres[name], atol=1e-6, rtol=1e-4, err_msg=name)
    jp = dict(tree_items(to_numpy(js.params)))
    for name, p in tree_items(ts.params):
        if name.endswith("bias_k"):
            continue
        moved = np.abs(jp[name] - p0[name])
        assert np.all(np.abs(p.numpy() - jp[name]) <= 1e-2 * LR + 1e-4 * moved), name


def test_residual_is_zero_before_the_switch_and_not_after(trainers):
    """The error-feedback residual stays zero through phase 1 and is
    nonzero from the first compressed step on, in the port as in the
    reference (their residuals' norms agree to 1e-3 relative)."""
    js, _, ts, th, _ = trainers
    norms = [m["ef_residual_norm"] for m in th]
    assert norms[:3] == [0.0] * 3 and all(n > 0 for n in norms[3:])
    jnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(x))
                               for x in jax.tree_util.tree_leaves(js.comp.residual))))
    np.testing.assert_allclose(norms[-1], jnorm, rtol=1e-3)


def test_kill_and_resume_keeps_the_residual_bit_exact(tmp_path):
    """SyntheticTask with compression, stopped after 7 steps (its last
    checkpoint holds a nonzero residual: the switch is at 5) and resumed
    to 10, ends bit for bit where an uninterrupted 10-step run ends:
    parameters, moments and residual."""
    full, params, _ = build(steps=10)
    a, _ = full.run(params)
    ck = Checkpointer(str(tmp_path), keep_last=3)
    first, params, _ = build(steps=7, ckpt=ck)
    mid, _ = first.run(params)
    assert ck.steps()[-1] == 7 and any(r.any() for _, r in tree_items(mid.comp.residual))
    again, params, _ = build(steps=10, ckpt=ck)
    b, _ = again.run(params)
    fa, fb = (dict(tree_flatten_named(s)) for s in (a, b))
    assert fa.keys() == fb.keys() and any(k.startswith("comp/residual/") for k in fa)
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=k)


class StandIn:
    """A mesh as the placement rules of both packages read it."""

    axis_names = ("data", "model")

    def __init__(self, data, model):
        self.devices = np.empty((data, model), dtype=object)


def _jax_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, PartitionSpec))[0]
    return {_path_str(p): tuple(s) for p, s in leaves}


@pytest.fixture(scope="module")
def states():
    """The reduced gpt2-paper's TrainState with a residual in both packages
    (the port's from the reference's weights)."""
    jcfg, tcfg = configs()
    pj = TransformerLM(jcfg).init(jax.random.PRNGKey(0))
    jr = jcore.make_recipe("step", jcore.SparsityConfig(default=jcore.NMSparsity(2, 4)))
    jtr = JaxTrainer(lambda p, b: (0.0, {}), jr, jcore.StepConfig(),
                     JaxDataIterator(batch_fn=lambda s, b: None, batch_size=1, prefetch=0),
                     JaxTrainerConfig(compress_phase2=True))
    ttr = Trainer(lambda p, b: (0.0, {}),
                  tcore.make_recipe("step", tcore.SparsityConfig(default=tcore.NMSparsity(2, 4))),
                  tcore.StepConfig(), DataIterator(batch_fn=lambda s, b: None, batch_size=1,
                                                   prefetch=0),
                  TrainerConfig(compress_phase2=True))
    return jtr.init_state(pj), ttr.init_state(carry_over(to_numpy(pj), device="cpu"))


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 2)])
def test_train_placements_match_the_reference(states, shape, fsdp):
    """Every leaf of a TrainState carrying the error-feedback residual (the
    reference's but its PRNG key) takes the reference's placement, and a
    batch's leaves theirs; the residual mirrors its parameter."""
    js, ts = states
    mesh = StandIn(*shape)
    ref = _jax_specs(jax_state_pspecs(mesh, js, fsdp=fsdp))
    ours = dict(tree_flatten_named(state_pspecs(mesh, ts, fsdp=fsdp)))
    assert set(ours) == set(ref) - {"rng"}
    assert {k: ref[k] for k in ours} == ours
    wq = "body/sb_0/attn/wq"
    assert ours[f"comp/residual/{wq}"] == ours[f"params/{wq}"] == ours[f"opt/m/{wq}"]
    assert ("data" in ours[f"params/{wq}"]) == fsdp
    batch = {"tokens": np.zeros((8, 16), np.int32), "labels": np.zeros((8, 16), np.int32)}
    assert _jax_specs(jax_batch_pspecs(mesh, batch)) == dict(tree_items(
        batch_pspecs(mesh, {k: torch.from_numpy(v) for k, v in batch.items()})))
