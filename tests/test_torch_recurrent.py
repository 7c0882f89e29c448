"""The port's RG-LRU block and sliding-window attention held against the
JAX package on the same f32 inputs (made with numpy): ``rglru_block``
prefill from zero state and from a carried state, ``rglru_decode_step``,
the log-depth scan over a long sequence, ``chunked_attention(window=)``;
the layer plan of the full RecurrentGemma-9B config, and its maskable map.
Tolerance: ``torch_parity.LOGIT_TOL`` unless a test says otherwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models import recurrent as jrec
from repro.models.model import TransformerLM
from repro.models.model import init_params as jax_init_params
from repro.models.model import layer_plan as jax_layer_plan
from repro_torch import core as tcore
from repro_torch.checkpoint import carry_over
from repro_torch.configs import get_config
from repro_torch.configs.base import RGLRUConfig
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import recurrent as trec
from repro_torch.utils.tree import tree_items
from torch_parity import LOGIT_TOL, configs, to_numpy

ARCH = "recurrentgemma-9b"
D, W = 24, 32  # d_model, lru_width
JCFG, TCFG = jrec.RGLRUConfig(lru_width=W), RGLRUConfig(lru_width=W)


def _params(seed=0):
    """Random f32 RG-LRU parameters, the reference's shapes and Λ."""
    rng = np.random.default_rng(seed)
    p = {name: (rng.standard_normal(shape) * 0.3).astype(np.float32) for name, shape in (
        ("w_x", (D, W)), ("w_gate_branch", (D, W)), ("w_out", (W, D)), ("conv_w", (4, W)),
        ("w_a_gate", (D, W)), ("w_i_gate", (D, W)))}
    p["a_log_lambda"] = np.log(np.expm1(np.linspace(0.9, 0.999, W))).astype(np.float32)
    return p


def _both(arrays):
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or LOGIT_TOL))


@pytest.mark.parametrize("carried", [False, True])
def test_rglru_block_matches_the_reference(carried):
    """Prefill of 13 tokens, from zero state or from a carried LRU state
    and conv tail: output, final state and conv tail."""
    jp, tp = _both(_params())
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 13, D)).astype(np.float32)
    state = rng.standard_normal((2, W)).astype(np.float32) if carried else None
    conv = rng.standard_normal((2, 3, W)).astype(np.float32) if carried else None
    j_out = jrec.rglru_block(jnp.asarray(u), jp, JCFG,
                             None if state is None else jnp.asarray(state),
                             None if conv is None else jnp.asarray(conv))
    t_out = trec.rglru_block(torch.from_numpy(u), tp, TCFG,
                             None if state is None else torch.from_numpy(state),
                             None if conv is None else torch.from_numpy(conv))
    for t, j in zip(t_out, j_out):
        assert tuple(t.shape) == j.shape
        _close(t, j)
    assert t_out[1].dtype == torch.float32


def test_rglru_decode_steps_match_the_reference():
    """Five decode steps from a prefilled state, each against the
    reference's ``rglru_decode_step`` from the same state, and the chain
    against the prefill of the whole sequence."""
    jp, tp = _both(_params(2))
    rng = np.random.default_rng(3)
    u = rng.standard_normal((3, 9, D)).astype(np.float32)
    _, state, conv = trec.rglru_block(torch.from_numpy(u[:, :4]), tp, TCFG)
    outs = []
    for t in range(4, 9):
        step = u[:, t:t + 1]
        j_out = jrec.rglru_decode_step(jnp.asarray(step), jp, JCFG, jnp.asarray(state.numpy()),
                                       jnp.asarray(conv.numpy()))
        out, state, conv = trec.rglru_decode_step(torch.from_numpy(step), tp, TCFG, state, conv)
        for a, b in zip((out, state, conv), j_out):
            _close(a, b)
        outs.append(out)
    whole, final, tail = trec.rglru_block(torch.from_numpy(u), tp, TCFG)
    _close(torch.cat(outs, 1), whole[:, 4:].numpy())
    _close(state, final.numpy())
    _close(conv, tail.numpy())


def test_scan_stays_finite_over_a_long_sequence():
    """The doubling scan against a sequential f64 loop over 300 steps with
    decays down to exp(-8) a step, where a cumulative product of ``a``
    would underflow f32 after about a dozen steps."""
    rng = np.random.default_rng(4)
    a = np.exp(-8.0 * rng.uniform(0.0, 1.0, (2, 300, 8)))
    b = rng.standard_normal((2, 300, 8))
    h, ref = trec._scan(torch.from_numpy(a).float(), torch.from_numpy(b).float()), np.zeros_like(b)
    acc = np.zeros((2, 8))
    for t in range(300):
        acc = a[:, t] * acc + b[:, t]
        ref[:, t] = acc
    assert np.cumprod(a.astype(np.float32), axis=1)[:, -1].max() == 0.0  # the form avoided
    np.testing.assert_allclose(h.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_short_prompt_conv_tail_is_zero_padded():
    """A prompt shorter than ``conv_width - 1`` leaves a zero-padded conv
    tail (the reference keeps the short tail; ROADMAP.md §3): prefill of
    one token, then decode steps, equal the prefill of the whole sequence."""
    _, tp = _both(_params(5))
    u = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 4, D)).astype(np.float32))
    out, state, conv = trec.rglru_block(u[:, :1], tp, TCFG)
    assert conv.shape == (2, 3, W) and float(conv[:, :2].abs().max()) == 0.0
    outs = [out]
    for t in range(1, 4):
        out, state, conv = trec.rglru_decode_step(u[:, t:t + 1], tp, TCFG, state, conv)
        outs.append(out)
    whole, _, _ = trec.rglru_block(u, tp, TCFG)
    _close(torch.cat(outs, 1), whole.numpy())


@pytest.mark.parametrize("window", [None, 5, 16])
def test_chunked_attention_window_matches_the_reference(window):
    """Causal MQA attention over 23 positions in chunks of 8, with a window
    smaller than a chunk, one spanning chunks, and none."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 23, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 23, 1, 8)).astype(np.float32) for _ in range(2))
    ref = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    window=window, chunk=8)
    out = tlayers.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    window=window, chunk=8)
    _close(out, ref)


def test_layer_plan_of_the_full_config():
    """38 layers: no head, the period (rec, rec, attn) stacked 12 times,
    two trailing RG-LRU layers, as the reference plans them; a hybrid
    pattern with other kinds, a hybrid family without a pattern and rec
    layers without an RG-LRU config are refused (M-RoPE is taken:
    ``test_mrope_on_the_attention_layers_matches_the_reference``)."""
    cfg = get_config(ARCH)
    plan = tmodel.layer_plan(cfg)
    assert (plan.head, plan.period, plan.n_body, plan.tail) == (
        (), ("rec", "rec", "attn"), 12, ("rec", "rec"))
    assert dataclasses.astuple(jax_layer_plan(jax_get_config(ARCH))) == dataclasses.astuple(plan)
    for bad in (dict(layer_pattern=("rec", "ssm")), dict(layer_pattern=None),
                dict(rglru=None)):
        with pytest.raises(NotImplementedError):
            tmodel.layer_plan(dataclasses.replace(cfg, **bad))


def test_mrope_on_the_attention_layers_matches_the_reference():
    """The reduced hybrid with ``rope="mrope"``: its local-attention layers
    rotate by three distinct position streams (the RG-LRU layers read no
    position), a forward's logits against the reference's."""
    jcfg, tcfg = (dataclasses.replace(c, rope="mrope") for c in configs(ARCH))
    jp = jax.jit(lambda k: jax_init_params(jcfg, k))(jax.random.PRNGKey(0))
    tp = carry_over(to_numpy(jp), device="cpu")
    rng = np.random.default_rng(9)
    toks = rng.integers(0, tcfg.vocab, (2, 21)).astype(np.int32)
    i = np.arange(21)
    pos = (np.stack([i // 5, i % 5, (i * 3) % 7], -1)[None] + rng.integers(0, 9, (2, 1, 3)))
    batch = {"tokens": toks, "positions": pos.astype(np.int32)}
    jl, _, _ = jax.jit(lambda p, b: TransformerLM(jcfg).forward(p, b, remat=False))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = tmodel.forward(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl, jl)


def test_maskable_map_matches_the_reference():
    """The 2:4 policy masks the same leaves in both packages: all five
    RG-LRU matrices and the attention and MLP weights; the conv, Λ, norms
    and the tied embedding stay dense.  On the reduced tree (the port's
    own init) and on the full config's leaf names and shapes."""
    jcfg, tcfg = configs(ARCH, n_layers=8)
    jpol = jcore.SparsityConfig(default=jcore.NMSparsity(2, 4))
    tpol = tcore.SparsityConfig(default=tcore.NMSparsity(2, 4))
    jtree = dict(tree_items(to_numpy(jax_init_params(jcfg, jax.random.PRNGKey(0)))))
    jmap = {name: jpol.pattern_for(name, p.shape) is not None for name, p in jtree.items()}
    ttree = tmodel.init_params(tcfg, device="cpu")
    tmap = {name: p is not None for name, p in tree_items(tcore.maskable_map(ttree, tpol))}
    assert tmap == jmap
    for name, p in tree_items(ttree):  # the port's own init: the reference's shapes and types
        assert tuple(p.shape) == jtree[name].shape and str(p.dtype)[6:] == str(jtree[name].dtype)
    masked = {name for name, on in tmap.items() if on}
    rec = {f"{g}/mixer/{w}" for g in ("body/sb_0", "body/sb_1", "tail_0", "tail_1")
           for w in ("w_x", "w_gate_branch", "w_out", "w_a_gate", "w_i_gate")}
    assert rec <= masked
    assert not any("conv_w" in n or "a_log_lambda" in n or "embed" in n for n in masked)
    shapes = jax.eval_shape(lambda k: jax_init_params(jax_get_config(ARCH), k),
                            jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        jpat, tpat = jpol.pattern_for(name, leaf.shape), tpol.pattern_for(name, leaf.shape)
        assert (jpat is None) == (tpat is None), name
        if tpat is not None:
            assert (tpat.n, tpat.m, tpat.group_axis % len(leaf.shape)) == (
                jpat.n, jpat.m, jpat.group_axis % len(leaf.shape)), name

