"""M-RoPE and the stub frontends (qwen2-vl-2b, musicgen-large) in the port,
held against the JAX package on the same f32 weights at ``reduced()``
shapes: ``apply_mrope`` at D 16 and 128 on distinct (t, h, w) streams and
bit-equal to ``apply_rope`` on a broadcast position; full forwards of both
archs with ``tokens``, with ``embeds`` and with explicit positions on the
masked-dense and the compressed tree; prefill then decode steps on the slab
and the paged pool, and prompt chunks, against the reference's calls;
greedy streams of the chunking engine against the reference's
``DecodeEngine(mesh=None)`` (the plan, the tree, the maskable map and
the slab and paged engines' streams of both archs are in
``test_torch_archs.py``); ``loss_fn`` on an ``embeds`` batch and one
STEP train step; the ``frontend`` subtree carried over and through both
packages' checkpoints; the serve CLI's refusal of frontend archs and its
``--no-donate``.

Tolerances: f32 logits within ``torch_parity.LOGIT_TOL`` (sums in other
orders); ``apply_mrope`` within 1e-5 (f32 sines of angles up to 1e3 rad
from two libraries); losses and the gradient norm to 1e-5 relative,
gradients within 1e-6 (as ``test_torch_train.py``); the parameters after
one Adam step within 0.1 of the learning rate and 99.9 % of them within
1e-4 of it (a coordinate whose gradient is near zero takes a step of
lr·g/(|g| + eps), which the gradient's last bits move: measured 0.035 and
0.074 of lr at most, 1e-5 at the 99.9th percentile); greedy streams
token for token wherever the f32 top-2 margin clears
``torch_parity.MARGIN``; names, shapes and masks exact."""
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.checkpoint import load_pytree as jax_load_pytree
from repro.checkpoint import save_pytree as jax_save_pytree
from repro.configs import get_config as jax_get_config
from repro.models import cache as jcache
from repro.models import layers as jlayers
from repro.models.model import TransformerLM
from repro.models.model import init_params as jax_init_params
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SamplingParams as JaxSampling
from repro.train.loop import TrainState as JaxTrainState
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch import core as tcore
from repro_torch.checkpoint import carry_over, load_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import frontend_dim
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.cache import PagedLayout, SlabLayout
from repro_torch.serving import DecodeEngine, SamplingParams
from repro_torch.sparse_infer import CompressedTensor
from repro_torch.train import TrainState, make_train_step
from repro_torch.train.loop import compute_grads
from repro_torch.utils.tree import tree_items
from torch_parity import LOGIT_TOL, assert_streams_agree, prompts, to_numpy, trees

ARCHS = ("qwen2-vl-2b", "musicgen-large")
MROPE_TOL = dict(rtol=1e-5, atol=1e-5)
LR, LOSS_RTOL, GRAD_ATOL = 3e-3, 1e-5, 1e-6


@pytest.fixture(scope="module")
def setups():
    """Each arch's ``trees`` (the reference's STEP 2:4 export and its
    compressed artifact, both carried across), built once on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = trees(arch=arch)
        return cache[arch]

    return get


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or LOGIT_TOL))


def _streams3(rng, b, s):
    """Distinct (t, h, w) streams, as a frame of patches gives them: t
    steps every 4 positions, h and w walk a 4-wide grid, plus an offset."""
    i = np.arange(s)
    base = np.stack([i // 4, (i % 4) // 2, i % 2], -1)
    return (base[None] + rng.integers(0, 50, (b, 1, 3))).astype(np.int32)


def _batch(cfg, rng, kind: str, b: int = 2, s: int = 13) -> dict:
    """A numpy batch of ``kind``: ``tokens``, ``embeds``, or ``embeds`` with
    explicit ``positions`` ((B, S, 3) streams under M-RoPE, else (B, S)
    from an offset)."""
    if kind == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    out = {"embeds": rng.standard_normal((b, s, frontend_dim(cfg))).astype(np.float32)}
    if kind == "positions":
        out["positions"] = (_streams3(rng, b, s) if cfg.rope == "mrope"
                            else (np.arange(s)[None] + rng.integers(0, 50, (b, 1))).astype(
                                np.int32))
    return out


@pytest.mark.parametrize("d", [16, 128])
def test_apply_mrope_matches_the_reference(d):
    """Sections 2/3/3 of D/2 (16/24/24 at D 128), theta 1e6 as the
    configs pass it; the distinct streams move the result off RoPE of the
    first stream, so the test tells the two apart."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 9, 3, d)).astype(np.float32)
    pos = _streams3(rng, 2, 9) * 7
    assert tlayers.mrope_sections(d) == ([2, 3, 3] if d == 16 else [16, 24, 24])
    for theta in (1e6, 1e4):
        want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
        got = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta=theta)
        _close(got, want, **MROPE_TOL)
        rope = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]), theta)
        assert (got - rope).abs().max() > 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrope_of_a_broadcast_position_is_rope_bit_for_bit(dtype):
    """The chunk and decode routes give M-RoPE one position in all three
    streams: the same angles, so the same bits as RoPE."""
    x = torch.randn((3, 5, 4, 128), generator=torch.Generator().manual_seed(1)).to(dtype)
    pos = torch.randint(0, 4000, (3, 5), generator=torch.Generator().manual_seed(2))
    assert torch.equal(tlayers.apply_mrope(x, pos[..., None].expand(3, 5, 3), theta=1e6),
                       tlayers.apply_rope(x, pos, 1e6))


@pytest.mark.parametrize("inputs", ["tokens", "embeds", "positions"])
@pytest.mark.parametrize("kind", ["dense", "compressed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(setups, arch, kind, inputs):
    jcfg, tcfg, t = setups(arch)
    jp, tp = t[kind]
    batch = _batch(tcfg, np.random.default_rng(3), inputs)
    jm = TransformerLM(jcfg)  # jitted: eager jnp compiles each op of a new shape
    jl, _, _ = jax.jit(lambda p, b: jm.forward(p, b, remat=False))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = tmodel.forward(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl, jl)
    proj = tp["frontend"]["frontend_proj"]  # carried over, compressed in the artifact
    assert isinstance(proj, CompressedTensor) == (kind == "compressed")


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_carry_the_frontend_both_ways(tmp_path, arch):
    """The reference's bf16 init in its npz format, read by the port, and
    the port's own init written back and read by the reference: every
    leaf, ``frontend/frontend_proj`` among them, bit for bit."""
    cfg = jax_get_config(arch, smoke=True)
    jp = jax.jit(lambda k: jax_init_params(cfg, k))(jax.random.PRNGKey(1))
    jax_save_pytree(str(tmp_path / "ref"), jp)
    tp, _ = load_pytree(str(tmp_path / "ref"), device="cpu")
    jf = dict(tree_items(to_numpy(jp)))
    assert sorted(dict(tree_items(tp))) == sorted(jf) and "frontend/frontend_proj" in jf
    for name, leaf in tree_items(tp):
        assert str(leaf.dtype)[6:] == str(jf[name].dtype), name
        np.testing.assert_array_equal(leaf.view(torch.int16).numpy() if leaf.dtype ==
                                      torch.bfloat16 else leaf.numpy(),
                                      jf[name].view(np.int16) if leaf.dtype == torch.bfloat16
                                      else jf[name], err_msg=name)
    own = tmodel.init_params(get_config(arch, smoke=True), seed=2, device="cpu")
    save_pytree(str(tmp_path / "port"), own)
    back, _ = jax_load_pytree(str(tmp_path / "port"), jp)
    for name, leaf in tree_items(to_numpy(back)):
        want = dict(tree_items(own))[name]
        assert torch.equal(torch.from_numpy(np.asarray(leaf, np.float32)), want.float()), name


def _prefilled(setups, arch, layout):
    """Both packages' caches after one ragged batched prefill (lengths 9
    and 6 into lanes 1 and 0, the shorter padded) of the compressed tree on
    ``layout`` (paged tables map scattered page ids, 16 the sentinel)."""
    jcfg, tcfg, t = setups(arch)
    jp, tp = t["compressed"]
    jm = TransformerLM(jcfg)
    max_len, ps, num_pages = 16, 4, 16
    if layout == "paged":
        jlay = jcache.paged_layout_for(jcfg, max_len, page_size=ps, num_pages=num_pages)
        tlay = PagedLayout(page_size=ps, num_pages=num_pages, max_len=max_len)
    else:
        jlay, tlay = jcache.SlabLayout(max_len), SlabLayout(max_len)
    jc = jm.init_cache(2, max_len, layout=jlay)
    tc = tmodel.init_cache(tcfg, 2, max_len, layout=tlay, device="cpu")
    if layout == "paged":
        table = np.array([[7, 2, 11, 3], [4, 0, 5, 9]], np.int32)
        jc["tables"] = {"full": jnp.asarray(table)}
        tc["tables"]["full"].copy_(torch.from_numpy(table))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tcfg.vocab, (2, 9)).astype(np.int32)
    lanes, lens = np.array([1, 0], np.int32), np.array([9, 6], np.int32)
    jl, _, prod = jax.jit(lambda p, x: jm.forward(p, {"tokens": x}, remat=False,
                                                  want_cache=True))(jp, jnp.asarray(toks))
    jc = jm.write_prefill(jc, prod, jnp.asarray(lanes), jnp.asarray(lens), jlay)
    tl, tprod = tmodel.forward(tp, tcfg, torch.from_numpy(toks), want_cache=True)
    tmodel.write_prefill(tc, tcfg, tprod, torch.from_numpy(lanes).long(),
                         torch.from_numpy(lens), tlay)
    _close(tl, jl)
    return jm, jp, jc, jlay, tcfg, tp, tc, tlay


@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_steps(setups, arch, layout):
    """Three decode steps from the prefilled state: M-RoPE's decode route
    broadcasts each lane's position over the three streams, as the
    reference's does."""
    jm, jp, jc, jlay, tcfg, tp, tc, tlay = _prefilled(setups, arch, layout)
    step = jax.jit(lambda p, x, c: jm.decode_step(p, x, c, jlay))
    for toks in np.random.default_rng(5).integers(0, tcfg.vocab, (3, 2)):
        jl, jc = step(jp, jnp.asarray(toks, jnp.int32), jc)
        tl, tc = tmodel.decode_step(tp, tcfg, torch.from_numpy(toks).int(), tc, tlay)
        _close(tl, jl)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunks_match_the_reference(setups, arch):
    """Two lanes' prompts of 11 and 7 tokens in chunks of 4 on the slab
    through both packages' ``prefill_chunk`` (M-RoPE on the chunk's
    broadcast positions): each live row's last logits, and the lengths."""
    jcfg, tcfg, t = setups(arch)
    jp, tp = t["compressed"]
    jm = TransformerLM(jcfg)
    max_len, csz, lens = 16, 4, (11, 7)
    jlay, tlay = jcache.SlabLayout(max_len), SlabLayout(max_len)
    jc = jm.init_cache(2, max_len, layout=jlay)
    tc = tmodel.init_cache(tcfg, 2, max_len, layout=tlay, device="cpu")
    rng = np.random.default_rng(6)
    proms = [rng.integers(0, tcfg.vocab, n) for n in lens]
    chunk = jax.jit(lambda p, x, c, ln, st, le: jm.prefill_chunk(p, x, c, ln, st, le, jlay))
    for start in range(0, max(lens), csz):
        toks = np.zeros((2, csz), np.int32)
        lengths = np.zeros((2,), np.int32)
        for i, p in enumerate(proms):
            part = p[start:start + csz]
            toks[i, :len(part)], lengths[i] = part, len(part)
        lanes = np.where(lengths > 0, np.arange(2), 2).astype(np.int32)
        starts = np.full((2,), start, np.int32)
        jl, jc = chunk(jp, jnp.asarray(toks), jc, jnp.asarray(lanes), jnp.asarray(starts),
                       jnp.asarray(lengths))
        tl, tc = tmodel.prefill_chunk(tp, tcfg, torch.from_numpy(toks), tc,
                                      torch.from_numpy(lanes), torch.from_numpy(starts),
                                      torch.from_numpy(lengths), tlay)
        live = lengths > 0
        _close(tl[torch.from_numpy(live)], np.asarray(jl)[live])
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(lens))
    np.testing.assert_array_equal(np.asarray(jc["len"]), np.asarray(lens))


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_streams_match_the_reference(setups, arch):
    """Three requests of 5-13 prompt tokens over two lanes (slot reuse) in
    chunks of 4 on a pool, the port's engine against the reference's on
    the same keywords: streams token for token wherever the margin clears,
    the same prefill batches and chunk dispatches, every page back in the
    pool.  (The slab and paged engines without chunks:
    ``test_torch_archs.py::test_greedy_streams_match_jax``.)"""
    jcfg, tcfg, t = setups(arch)
    jp, tp = t["compressed"]
    kw = dict(max_batch=2, max_len=32, seed=0, num_pages=24, page_size=4, prefill_chunk=4)
    reqs = list(zip(prompts(3, tcfg.vocab, lo=5, step=4), [6, 8, 5]))
    teng = DecodeEngine(tcfg, tp, device="cpu", **kw)
    jeng = JaxEngine(TransformerLM(jcfg), jp, **kw)
    out = []
    for eng, sp in ((teng, SamplingParams), (jeng, JaxSampling)):
        uids = [eng.submit(p, sp(max_new_tokens=n)) for p, n in reqs]
        res = eng.run()
        out.append([res[u].tokens for u in uids])
    for (p, _), a, b in zip(reqs, *out):
        assert_streams_agree(tcfg, tp, p, a, b)
    tst, jst = teng.stats(), jeng.stats()
    assert (tst["prefill_batches"], tst["prefill_chunks"]) == (
        jst["prefill_batches"], jst["prefill_chunks"])
    assert tst["prefill_chunks"] > 0 and teng.pool.free_pages == 24


def _step_cfgs(core):
    """STEP 2:4 with AutoSwitch clipped to switch at the first step."""
    return (core.make_recipe("step", core.SparsityConfig(default=core.NMSparsity(2, 4))),
            core.StepConfig(learning_rate=LR, b2=0.98, autoswitch=core.AutoSwitchConfig(
                eps=2e-5, window=4, t_min=0, t_max=0)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_a_step_step_on_embeds(setups, arch):
    """On an ``embeds`` batch with explicit positions, labels and a loss
    mask: ``loss_fn``'s parts; the mask phase's forward from these weights,
    its 2:4 masks (``frontend_proj``'s included) equal and its STE
    gradients; one STEP train step (the switch step) with its loss and
    gradient norm and the parameters after it; against the reference's."""
    jcfg, tcfg, t = setups(arch)
    jp = t["dense"][0]
    rng = np.random.default_rng(7)
    batch = _batch(tcfg, rng, "positions", b=2, s=12)
    batch["labels"] = rng.integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    batch["loss_mask"] = (rng.random((2, 12)) < 0.8).astype(np.float32)
    jm = TransformerLM(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def jloss(p):
        return jm.loss(p, jb, chunk=12, remat=False)

    def tloss(p, b):
        return tmodel.loss_fn(p, tcfg, b, chunk=12)

    tp = carry_over(to_numpy(jp), device="cpu")
    (jl, jparts), (tl, tparts) = jax.jit(jloss)(jp), tloss(tp, tb)
    for k, a, b in (("loss", tl, jl), ("ce", tparts["ce"], jparts["ce"]),
                    ("zloss", tparts["zloss"], jparts["zloss"])):
        np.testing.assert_allclose(float(a), float(b), rtol=LOSS_RTOL, err_msg=k)
    (jr, jsc), (tr, tsc) = _step_cfgs(jcore), _step_cfgs(tcore)
    # the mask phase's forward from these weights: masks and STE gradients
    jmasks, jact, _ = jr.masks_for_step(jp, jr.init_state(jp), jnp.bool_(True))
    tmasks, tact, _ = tr.masks_for_step(tp, tr.init_state(tp), True)
    jmask_np = dict(tree_items(to_numpy(jmasks)))
    assert tact and "frontend/frontend_proj" in tmasks
    for name, jmk in jmask_np.items():  # the reference's unmasked leaves carry ones
        want = tmasks[name].mask.numpy() if name in tmasks else np.ones_like(jmk)
        np.testing.assert_array_equal(want, jmk, err_msg=name)
    jg = jax.jit(jax.grad(lambda p: jloss(jr.forward_params(p, jmasks, jact))[0]))(jp)
    _, _, tg = compute_grads(tloss, tr, tp, tb, tmasks, tact)
    jf = dict(tree_items(to_numpy(jg)))
    for name, g in tree_items(tg):
        np.testing.assert_allclose(g.numpy(), jf[name], atol=GRAD_ATOL, rtol=1e-4,
                                   err_msg=name)
    jopt, topt = jcore.step_optimizer(jsc), tcore.step_optimizer(tsc)
    jstep = jax.jit(jax_make_train_step(lambda p, b: jm.loss(p, b, chunk=12), jr, jopt))
    tstep = make_train_step(tloss, tr, topt)
    js = JaxTrainState(jp, jopt.init(jp), jr.init_state(jp), None, jax.random.PRNGKey(0),
                       jnp.zeros((2,), jnp.int32))
    ts = TrainState(tp, topt.init(tp), tr.init_state(tp), np.zeros(2, np.int32))
    js, jmet = jstep(js, jb)
    ts, tmet = tstep(ts, tb)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=LOSS_RTOL, err_msg=k)
    assert bool(ts.opt.phase2) and bool(js.opt.phase2)
    jf = dict(tree_items(to_numpy(js.params)))
    diffs = np.concatenate([np.abs(p.numpy() - jf[n]).ravel() for n, p in tree_items(ts.params)])
    assert diffs.max() <= 0.1 * LR and np.quantile(diffs, 0.999) <= 1e-4 * LR, (
        diffs.max() / LR, np.quantile(diffs, 0.999) / LR)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_refuses_frontend_archs(arch):
    """As the reference's CLI: a ``SystemExit`` before anything is built."""
    with pytest.raises(SystemExit, match="token-input archs"):
        launch_serve.main(["--device", "cpu", "--arch", arch, "--batch", "1", "--gen", "2"])


def _cli(*extra):
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--device", "cpu", "--batch", "2", "--requests", "2",
                           "--prompt-len", "6", "--gen", "3", *extra])
    return json.loads(buf.getvalue().strip().splitlines()[-1])["summary"]


def test_serve_cli_takes_no_donate():
    """``--no-donate`` parses and changes nothing: the same greedy streams
    and counters as without it (PyTorch updates the cache in place)."""
    assert launch_serve.parse_args(["--no-donate"]).donate is False
    assert launch_serve.parse_args([]).donate is True
    a, b = _cli(), _cli("--no-donate")
    keys = ("greedy_streams", "decode_steps", "prefill_batches", "generated_tokens")
    assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
