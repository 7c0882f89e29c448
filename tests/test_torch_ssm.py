"""The port's Mamba-2 (SSD) family held against the JAX package on the same
f32 inputs (made with numpy) and weights carried across: ``ssd_chunked``
at a dividing chunk and with a given initial state, ``ssm_block`` at
lengths whose chunk divides, does not (a prime length: one-token chunks)
and lies under the conv width, eight ``ssm_decode_step`` updates, the
short prompt's conv tail; the reduced mamba2-2.7b (4 layers): the plan
and tree, the maskable map, forward logits, exact-length prefill then
decode on the slab and on the table-less paged pool, greedy streams
against ``DecodeEngine(mesh=None)``, the device scheduler's refills
against the sync scheduler, the refusals (speculative decoding, chunked
prefill, the prefix cache), the serve CLI, and the loss and gradients of
one STEP step.

Tolerances: f32 outputs, logits and states within 1e-5 relative or 1e-4
absolute (sums in other orders); greedy streams token for token wherever
the f32 top-2 margin clears ``torch_parity.MARGIN``; plans, tree keys,
masks and page counts exact."""
import dataclasses
import io
import json
import warnings
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as jax_get_config
from repro.models import ssm as jssm
from repro.models.model import TransformerLM
from repro.models.model import init_params as jax_init_params
from repro.models.model import layer_plan as jax_layer_plan
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SamplingParams as JaxSampling
from repro.serving.kv_pool import PagedKVPool as JaxPool
from repro_torch import core as tcore
from repro_torch.checkpoint import carry_over
from repro_torch.configs import get_config
from repro_torch.configs.base import SSMConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models.cache import SlabLayout
from repro_torch.serving import DecodeEngine, SamplingParams
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.sparse_infer import CompressedTensor
from repro_torch.train.loop import compute_grads
from repro_torch.utils.tree import tree_items
from torch_parity import assert_streams_agree, prompts, to_numpy, trees

ARCH = "mamba2-2.7b"
TOL = dict(rtol=1e-5, atol=1e-4)
# a mixer with two B/C groups (the reduced arch has one), 8 heads of 6
D = 24
JCFG = jssm.SSMConfig(d_state=8, head_dim=6, expand=2, n_groups=2, conv_width=4, chunk=8)
TCFG = SSMConfig(d_state=8, head_dim=6, expand=2, n_groups=2, conv_width=4, chunk=8)
MAX_LEN, PS = 40, 4


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **TOL)


def _params(seed=0):
    """Random f32 mixer parameters with the reference's shapes."""
    dims = jssm.ssm_dims(D, JCFG)
    nh, cd = dims["n_heads"], dims["d_inner"] + 2 * JCFG.n_groups * JCFG.d_state
    rng = np.random.default_rng(seed)
    p = {name: (rng.standard_normal(shape) * 0.3).astype(np.float32) for name, shape in (
        ("w_in", (D, dims["d_in_proj"])), ("w_out", (dims["d_inner"], D)),
        ("conv_w", (JCFG.conv_width, cd)), ("dt_bias", (nh,)))}
    p["a_log"] = np.log(np.linspace(1.0, 16.0, nh)).astype(np.float32)
    p["d_skip"] = (1 + 0.1 * rng.standard_normal(nh)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


# the reference's functions jitted (eager jnp compiles every op of a new
# shape on its first call, which takes several times longer)
_jax_block = jax.jit(lambda u, p: jssm.ssm_block(u, p, D, JCFG))


def _u(shape, seed):
    u = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(u), torch.from_numpy(u)


@pytest.fixture(scope="module")
def setup():
    return trees(arch=ARCH)


def test_dims_match_the_reference():
    for cfg in (TCFG, get_config(ARCH).ssm):
        j = jssm.ssm_dims(D, jssm.SSMConfig(**dataclasses.asdict(cfg)))
        t = tssm.ssm_dims(D, cfg)
        assert {k: t[k] for k in j} == j
        assert t["conv_dim"] == j["d_inner"] + 2 * cfg.n_groups * cfg.d_state


@pytest.mark.parametrize("s,chunk,carried", [(16, 8, False), (16, 4, True), (24, 8, True)])
def test_ssd_chunked_matches_the_reference(s, chunk, carried):
    """The chunked scan over 2-6 chunks, from zero or a given state: y and
    the final state."""
    h, p, g, n = 8, 6, 2, 8
    rng = np.random.default_rng(s + chunk)
    x, b, c = (rng.standard_normal(shp).astype(np.float32)
               for shp in ((2, s, h, p), (2, s, g, n), (2, s, g, n)))
    dt = np.log1p(np.exp(rng.standard_normal((2, s, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    s0 = rng.standard_normal((2, h, p, n)).astype(np.float32) if carried else None
    args = (x, dt, a_log, b, c)
    jy, js = jax.jit(jssm.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, args), chunk, None if s0 is None else jnp.asarray(s0))
    ty, ts = tssm.ssd_chunked(*map(torch.from_numpy, args), chunk,
                              None if s0 is None else torch.from_numpy(s0))
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("s", [16, 12, 13, 2])
def test_ssm_block_matches_the_reference(s):
    """Chunks of 8 (S = 16), 6 (12: the largest divisor not above 8) and 1
    (13, a prime); S = 2 leaves a conv tail shorter than the conv's 3:
    output, final state and the conv tail."""
    jp, tp = _params()
    ju, tu = _u((2, s, D), s)
    jo, (jst, jtail) = _jax_block(ju, jp)
    to, (tst, ttail) = tssm.ssm_block(tu, tp, D, TCFG)
    _close(to, jo)
    _close(tst, jst)
    assert ttail.shape == jtail.shape == (2, min(s, 3), 80)
    _close(ttail, jtail)


def test_eight_decode_steps_match_the_reference():
    """From the state and conv tail of a 10-token prefill, eight recurrent
    updates on the same inputs: output, state and conv state each step."""
    jp, tp = _params(1)
    ju, tu = _u((2, 10, D), 3)
    _, (jst, jcv) = _jax_block(ju, jp)
    _, (tst, tcv) = tssm.ssm_block(tu, tp, D, TCFG)
    jdec = jax.jit(lambda u, p, st, cv: jssm.ssm_decode_step(u, p, D, JCFG, st, cv))
    for step in range(8):
        ju, tu = _u((2, 1, D), 10 + step)
        jo, jst, jcv = jdec(ju, jp, jst, jcv)
        to, tst, tcv = tssm.ssm_decode_step(tu, tp, D, TCFG, tst, tcv)
        for t, j in ((to, jo), (tst, jst), (tcv, jcv)):
            _close(t, j)


def test_plan_tree_and_maskable_map():
    """64 stacked SSM blocks, as the reference plans them; the reduced
    model's own init has the reference's leaf names, shapes and types (no
    ``post`` norm and no MLP; ``a_log``, ``d_skip`` and ``dt_bias`` f32);
    the 2:4 policy masks ``w_in`` and ``w_out`` alone, on the full
    config's names and shapes too.  A hybrid pattern with SSM blocks, an
    SSM family without its config and RoPE on it are refused."""
    cfg = get_config(ARCH)
    plan = tmodel.layer_plan(cfg)
    assert (plan.head, plan.period, plan.n_body, plan.tail) == ((), ("ssm",), 64, ())
    assert dataclasses.astuple(jax_layer_plan(jax_get_config(ARCH))) == dataclasses.astuple(plan)
    for bad in (dict(ssm=None), dict(rope="rope"), dict(layer_pattern=("ssm", "attn"))):
        with pytest.raises(NotImplementedError):
            tmodel.layer_plan(dataclasses.replace(cfg, **bad))
    tcfg, jcfg = get_config(ARCH, smoke=True), jax_get_config(ARCH, smoke=True)
    assert dataclasses.asdict(tcfg.ssm) == dataclasses.asdict(jcfg.ssm) == dict(
        d_state=16, head_dim=8, expand=2, n_groups=1, conv_width=4, chunk=8)
    jtree = dict(tree_items(to_numpy(jax_init_params(jcfg, jax.random.PRNGKey(0)))))
    ttree = tmodel.init_params(tcfg, device="cpu")
    assert sorted(dict(tree_items(ttree))) == sorted(jtree)
    for name, leaf in tree_items(ttree):
        assert tuple(leaf.shape) == jtree[name].shape, name
        assert str(leaf.dtype)[6:] == str(jtree[name].dtype), name
    for name in ("a_log", "d_skip", "dt_bias"):  # the reference's values (log: to an ulp)
        np.testing.assert_allclose(ttree["body"]["sb_0"]["mixer"][name].numpy(),
                                   jtree[f"body/sb_0/mixer/{name}"], rtol=1e-6)
    tpol = tcore.SparsityConfig(default=tcore.NMSparsity(2, 4))
    jpol = jcore.SparsityConfig(default=jcore.NMSparsity(2, 4))
    masked = {n for n, p in tree_items(tcore.maskable_map(ttree, tpol)) if p is not None}
    assert masked == {"body/sb_0/mixer/w_in", "body/sb_0/mixer/w_out"}
    shapes = jax.eval_shape(lambda k: jax_init_params(jax_get_config(ARCH), k),
                            jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        jpat, tpat = jpol.pattern_for(name, leaf.shape), tpol.pattern_for(name, leaf.shape)
        assert (jpat is None) == (tpat is None) == (name.split("/")[-1] not in (
            "w_in", "w_out")), name


def test_carried_tree(setup):
    """The compressed tree carried across keeps the f32 recurrence
    parameters and the dense conv; ``w_in`` and ``w_out`` are compressed."""
    _, _, t = setup
    for kind in ("dense", "compressed"):
        mixer = t[kind][1]["body"]["sb_0"]["mixer"]
        for name in ("a_log", "d_skip", "dt_bias", "conv_w"):
            assert mixer[name].dtype == torch.float32 and not isinstance(
                mixer[name], CompressedTensor), (kind, name)
        assert isinstance(mixer["w_in"], CompressedTensor) == (kind == "compressed")
        assert "embed" in t[kind][1] and "unembed" not in t[kind][1]  # tied


@pytest.mark.parametrize("kind", ["dense", "compressed"])
def test_forward_logits(setup, kind):
    """19 tokens (a prime length: one-token chunks) through 4 layers."""
    jcfg, tcfg, t = setup
    jp, tp = t[kind]
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 19))
    jm = TransformerLM(jcfg)
    jl, _, _ = jax.jit(lambda p, x: jm.forward(p, {"tokens": x}, remat=False))(
        jp, jnp.asarray(toks))
    tl, _ = tmodel.forward(tp, tcfg, torch.from_numpy(toks))
    _close(tl, jl)


def test_short_prompt_conv_tail_is_left_padded(setup):
    """``prefill`` of a 2-token prompt: the conv state holds a zero row
    before the prompt's two, as the reference's prefill pads it; the
    logits and state agree."""
    jcfg, tcfg, t = setup
    jp, tp = t["compressed"]
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (2, 2))
    jm = TransformerLM(jcfg)
    jl, jc = jax.jit(lambda p, x: jm.prefill(p, {"tokens": x}, 8))(jp, jnp.asarray(toks))
    tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(toks), 8)
    _close(tl, jl)
    for name in ("state", "conv"):
        _close(tc["body"]["sb_0"][name], jc["body"]["sb_0"][name])
    assert tc["body"]["sb_0"]["conv"].shape[2] == 3
    assert not tc["body"]["sb_0"]["conv"][:, :, 0].any()


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_prefill_then_decode_steps(setup, layout):
    """Two prompts prefilled at exact lengths (13 tokens into lane 1, 2 into
    lane 0: a short conv tail), then 8 decode steps of the same tokens in
    both packages: logits every step, states and conv tails after prefill
    and at the end.  The pool has no table: ``alloc_prefill`` and
    ``ensure_steps`` take no page in either package."""
    jcfg, tcfg, t = setup
    jp, tp = t["compressed"]
    jm = TransformerLM(jcfg)
    rng = np.random.default_rng(1)
    seqs = {1: rng.integers(0, tcfg.vocab, 13), 0: rng.integers(0, tcfg.vocab, 2)}
    feed = rng.integers(0, tcfg.vocab, (8, 2))
    jfwd = jax.jit(lambda p, toks: jm.forward(p, {"tokens": toks}, remat=False,
                                              want_cache=True))
    if layout == "paged":
        jpool = JaxPool(jm, max_batch=2, max_len=MAX_LEN, num_pages=8, page_size=PS)
        tpool = PagedKVPool(tcfg, max_batch=2, max_len=MAX_LEN, num_pages=8, page_size=PS,
                            device="cpu")
        jlay, tlay, jc, tc = jpool.layout, tpool.layout, jpool.cache, tpool.cache
        assert (tlay.pages_full, tlay.pages_win) == (jlay.pages_full, jlay.pages_win) == (0, 0)
        assert tc["tables"] == {} and tpool.device_tables() == {}
    else:
        jlay, tlay = None, SlabLayout(MAX_LEN)
        jc = jm.init_cache(2, MAX_LEN)
        tc = tmodel.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    for lane, seq in seqs.items():
        if layout == "paged":
            assert jpool.alloc_prefill(lane, len(seq)) and tpool.alloc_prefill(lane, len(seq))
        lanes, lens = np.array([lane], np.int32), np.array([len(seq)], np.int32)
        jl, _, prod = jfwd(jp, jnp.asarray(seq[None]))
        jc = jm.write_prefill(jc, prod, jnp.asarray(lanes), jnp.asarray(lens), jlay)
        tl, tprod = tmodel.forward(tp, tcfg, torch.from_numpy(seq[None]), want_cache=True)
        tmodel.write_prefill(tc, tcfg, tprod, torch.from_numpy(lanes).long(),
                             torch.from_numpy(lens), tlay)
        _close(tl, jl)

    def states():
        for name in ("state", "conv"):
            _close(tc["body"]["sb_0"][name], jc["body"]["sb_0"][name])

    states()
    jdec = jax.jit(lambda p, tok, c: jm.decode_step(p, tok, c, jlay))
    for step in feed:
        if layout == "paged":
            for lane in (0, 1):
                pos = int(tc["len"][lane])
                assert jpool.ensure_steps(lane, pos, 1) and tpool.ensure_steps(lane, pos, 1)
        jl, jc = jdec(jp, jnp.asarray(step, jnp.int32), jc)
        tl, tc = tmodel.decode_step(tp, tcfg, torch.from_numpy(step).int(), tc, tlay)
        _close(tl, jl)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    states()
    if layout == "paged":
        assert tpool.free_pages == jpool.free_pages == 8 and tpool._free == jpool._free


def _run(eng, reqs, sp_cls):
    uids = [eng.submit(p, sp_cls(max_new_tokens=n)) for p, n in reqs]
    res = eng.run()
    return [res[u].tokens for u in uids], [res[u].finish_reason for u in uids]


REQS = ((5, 9), (11, 12), (5, 7), (11, 10))  # (prompt length, budget): two exact lengths
ENGINE = dict(max_batch=2, max_len=MAX_LEN, seed=0, steps_per_dispatch=4)


def _reqs(vocab):
    return [(np.random.default_rng(100 + r).integers(0, vocab, n).tolist(), g)
            for r, (n, g) in enumerate(REQS)]


@pytest.fixture(scope="module")
def jax_streams(setup):
    """The reference's slab engine on ``REQS`` over two lanes (slot reuse),
    K = 4: streams, finish reasons, prefill batches."""
    jcfg, tcfg, t = setup
    eng = JaxEngine(TransformerLM(jcfg), t["compressed"][0], **ENGINE)
    return (*_run(eng, _reqs(tcfg.vocab), JaxSampling), eng.prefill_batches)


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_greedy_streams_match_jax(setup, jax_streams, layout):
    """The port's slab and table-less paged engines against the reference's
    slab engine: exact-length prefill batches, streams token for token
    wherever the top-2 margin clears ``MARGIN``; the pool lends no page,
    its kernel route is ``none`` and its cache bytes are the states."""
    _, tcfg, t = setup
    tp = t["compressed"][1]
    jt, jr, j_batches = jax_streams
    paged = dict(num_pages=8, page_size=PS) if layout == "paged" else {}
    teng = DecodeEngine(tcfg, tp, device="cpu", **ENGINE, **paged)
    reqs = _reqs(tcfg.vocab)
    tt, tr = _run(teng, reqs, SamplingParams)
    for (p, _), a, b in zip(reqs, tt, jt):
        assert_streams_agree(tcfg, tp, p, a, b)
    if tt == jt:
        assert tr == jr
    assert teng.prefill_batches == j_batches
    dims = tssm.ssm_dims(tcfg.d_model, tcfg.ssm)
    per_lane = (dims["n_heads"] * tcfg.ssm.head_dim * tcfg.ssm.d_state * 4
                + (tcfg.ssm.conv_width - 1) * dims["conv_dim"] * 4)
    assert teng.kv_cache_bytes() == tcfg.n_layers * 2 * per_lane
    if layout == "paged":
        assert teng.pool.free_pages == 8 and teng.cache["tables"] == {}
        assert teng.kernel_route() == "none"


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_device_scheduler_refills_match_sync(setup, layout):
    """The device scheduler (4 steps a dispatch, one staged lane) refills
    lanes inside its loop, zeroing their states (``reset_lanes``) and
    feeding each prompt token by token; its streams agree with the sync
    scheduler's wherever the top-2 margin clears ``MARGIN`` (a fed prompt
    runs the recurrence where the sync scheduler's prefill runs SSD)."""
    _, tcfg, t = setup
    tp = t["compressed"][1]
    paged = dict(num_pages=8, page_size=PS) if layout == "paged" else {}
    reqs = _reqs(tcfg.vocab)
    sync = _run(DecodeEngine(tcfg, tp, device="cpu", **ENGINE, **paged), reqs, SamplingParams)
    deng = DecodeEngine(tcfg, tp, device="cpu", **ENGINE, **paged, max_steps_per_dispatch=4,
                        staged_lanes=1)
    dev = _run(deng, reqs, SamplingParams)
    assert deng.refills > 0 and dev[1] == sync[1]
    for (p, _), a, b in zip(reqs, dev[0], sync[0]):
        assert_streams_agree(tcfg, tp, p, a, b)


def test_reset_lanes_zeroes_ssm_rows():
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), param_dtype="float32")
    cache = tmodel.init_cache(tcfg, 3, 8, device="cpu")
    for name in ("state", "conv"):
        cache["body"]["sb_0"][name].fill_(1.0)
    tmodel.reset_lanes(tcfg, cache, torch.tensor([False, True, False]))
    for name in ("state", "conv"):
        x = cache["body"]["sb_0"][name]
        assert not x[:, 1].any() and bool((x[:, 0] == 1).all() and (x[:, 2] == 1).all())


def _cli(*extra):
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2", "--requests", "3",
                           "--prompt-len", "6", "--gen", "5", *extra])
    return json.loads(buf.getvalue().strip().splitlines()[-1])["summary"]


def test_refusals(setup):
    """Speculative decoding raises (a rejected draft's state cannot be rolled
    back); chunked prefill and the prefix cache are turned off, the latter
    with a warning, in the engine and the CLI; ``prefill_chunk`` itself
    raises for SSM mixers, as the reference's does."""
    _, tcfg, t = setup
    tp = t["compressed"][1]
    with pytest.raises(ValueError, match="SSM"):
        DecodeEngine(tcfg, tp, spec_gamma=2, verify_params=tp, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="SSM"):
        _cli("--spec-gamma", "2")
    for kw in ({}, dict(num_pages=8, page_size=PS)):
        assert DecodeEngine(tcfg, tp, prefill_chunk=4, device="cpu", **ENGINE,
                            **kw).prefill_chunk is None
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            eng = DecodeEngine(tcfg, tp, prefix_cache=True, device="cpu", **ENGINE, **kw)
        assert eng._prefix is None and any("prefix" in str(x.message).lower() for x in w)
    cache = tmodel.init_cache(tcfg, 1, 16, device="cpu")
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="attention-family"):
        tmodel.prefill_chunk(tp, tcfg, torch.zeros((1, 4), dtype=torch.int64), cache,
                             torch.zeros(1, dtype=torch.int32), 0 * one, 4 * one)
    with pytest.warns(UserWarning, match="prefix_cache"):
        summary = _cli("--paged", "--page-size", "4", "--prefill-chunk", "4", "--prefix-cache")
    assert summary["prefill_chunks"] == 0 and "prefix_hits" not in summary
    assert summary["generated_tokens"] == 15


@pytest.mark.parametrize("extra", [(), ("--paged", "--page-size", "4")])
def test_serve_cli_on_the_cpu(extra):
    """``--arch mamba2-2.7b`` (and ``--paged``): every request finishes its
    budget, prefilled at its exact length; the pool uses no page and no
    attention kernel route."""
    summary = _cli(*extra)
    assert summary["n_requests"] == 3 and summary["generated_tokens"] == 15
    assert all(len(s) == 5 for s in summary["greedy_streams"])
    assert summary["kernel_route"] == ("none" if extra else "slab")
    assert summary["kv_cache_bytes"] > 0


def test_one_step_step_loss_and_gradients(setup):
    """The STEP recipe's loss and gradients of one step on the reduced
    dense tree, against ``jax.grad`` of the reference's loss: the loss
    within 1e-5 relative, each gradient within 1e-6 absolute (+ 1e-4
    relative)."""
    jcfg, tcfg, t = setup
    jp = t["dense"][0]
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tcfg.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    model = TransformerLM(jcfg)
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda p: model.loss(p, batch, chunk=16)[0]))(jp)
    recipe = tcore.make_recipe("step", tcore.SparsityConfig(default=tcore.NMSparsity(2, 4)))
    pt = carry_over(to_numpy(jp), device="cpu")
    loss, _, tgrad = compute_grads(
        lambda p, b: tmodel.loss_fn(p, tcfg, b, chunk=16), recipe, pt,
        {k: torch.from_numpy(v) for k, v in batch.items()}, {}, False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jf = dict(tree_items(to_numpy(jgrad)))
    for name, g in tree_items(tgrad):
        np.testing.assert_allclose(g.numpy(), jf[name], atol=1e-6, rtol=1e-4, err_msg=name)
