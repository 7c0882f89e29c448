"""Reduced DeepSeek-V2-Lite (MLA + MoE, a dense ``head_0`` and a stacked
``body``) in the port, held against the JAX package on the same f32
weights: ``forward`` logits; a batched ragged prefill and three decode
steps on the slab; the port's absorbed paged decode (K2m's plain version)
against the reference's kernel route under ``force_mode("interpret")``;
greedy streams against ``DecodeEngine(mesh=None)`` on the slab and the
paged pool; ``carry_over`` of the tree; and the streamed export and
compression against the whole-tree functions.  Tolerance:
``torch_parity.LOGIT_TOL`` unless a test says otherwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.models import cache as jcache
from repro.models.model import TransformerLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SamplingParams as JaxSampling
from repro_torch import core as tcore
from repro_torch.models import model as tmodel
from repro_torch.models.cache import PagedLayout, SlabLayout
from repro_torch.serving import DecodeEngine, SamplingParams
from repro_torch.sparse_infer import (
    CompressedTensor,
    compress_params,
    compression_report,
    export_compressed,
)
from repro_torch.utils.tree import tree_items
from torch_parity import LOGIT_TOL, assert_streams_agree, configs, prompts, to_numpy, trees

ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module")
def setup():
    return trees(arch=ARCH)


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **LOGIT_TOL)


def test_plan_and_tree_match_the_reference(setup):
    """``head_0`` with a dense MLP, 3 stacked MLA + MoE blocks, an untied
    unembedding; the port's own init has the reference's leaf names, shapes
    and types."""
    jcfg, tcfg, t = setup
    plan = tmodel.layer_plan(tcfg)
    assert (plan.head, plan.period, plan.n_body) == (("attn:dense",), ("attn",), 3)
    jtree = dict(tree_items(to_numpy(TransformerLM(jcfg).init(jax.random.PRNGKey(0)))))
    ttree = dict(tree_items(tmodel.init_params(tcfg, device="cpu")))
    assert sorted(ttree) == sorted(jtree)
    for name, leaf in ttree.items():
        assert tuple(leaf.shape) == jtree[name].shape, name
        assert str(leaf.dtype)[6:] == str(jtree[name].dtype), name
    for bad in (dict(local_window=16), dict(family="ssm"), dict(family="hybrid")):
        with pytest.raises(NotImplementedError):
            tmodel.layer_plan(dataclasses.replace(tcfg, **bad))


def test_mla_reads_the_first_stream_of_mrope_positions(setup):
    """MLA under ``rope="mrope"`` takes the temporal stream of (B, S, 3)
    positions, as the reference's forward does: logits against the
    reference's, and equal to the port's on that stream alone."""
    jcfg, tcfg, t = setup
    jcfg, tcfg = (dataclasses.replace(c, rope="mrope") for c in (jcfg, tcfg))
    jp, tp = t["compressed"]
    rng = np.random.default_rng(8)
    toks = rng.integers(0, tcfg.vocab, (2, 11))
    pos = (np.arange(11)[None, :, None] * np.array([1, 2, 3]) + rng.integers(0, 9, (2, 1, 3)))
    pos = pos.astype(np.int32)
    jl, _, _ = TransformerLM(jcfg).forward(
        jp, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}, remat=False)
    tl, _ = tmodel.forward(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                      "positions": torch.from_numpy(pos)})
    _close(tl, jl)
    first, _ = tmodel.forward(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                         "positions": torch.from_numpy(pos[..., 0])})
    assert torch.equal(tl, first)


@pytest.mark.parametrize("kind", ["dense", "compressed"])
def test_forward_logits(setup, kind):
    jcfg, tcfg, t = setup
    jp, tp = t[kind]
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 11))
    jl, _, _ = TransformerLM(jcfg).forward(jp, {"tokens": jnp.asarray(toks)}, remat=False)
    tl, _ = tmodel.forward(tp, tcfg, torch.from_numpy(toks))
    _close(tl, jl)


def _prefilled(setup, layout):
    """Both packages' caches after one batched prefill of two ragged
    prompts into lanes 1 and 0 (paged tables map scattered page ids), and
    the decode tokens to feed."""
    jcfg, tcfg, t = setup
    jp, tp = t["compressed"]
    max_len, ps, num_pages = 16, 4, 10
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab, (2, 8))
    lens, lanes = np.array([5, 8], np.int32), np.array([1, 0], np.int32)
    table = np.array([[7, 2, 9, 10], [4, 0, 5, 10]], np.int32)  # 10 = sentinel
    jm = TransformerLM(jcfg)
    if layout == "paged":
        jlay = jcache.paged_layout_for(jcfg, max_len, page_size=ps, num_pages=num_pages)
        tlay = PagedLayout(page_size=ps, num_pages=num_pages, max_len=max_len)
    else:
        jlay, tlay = jcache.SlabLayout(max_len), SlabLayout(max_len)
    jc = jm.init_cache(2, max_len, layout=jlay)
    tc = tmodel.init_cache(tcfg, 2, max_len, layout=tlay, device="cpu")
    if layout == "paged":
        jc["tables"] = {"full": jnp.asarray(table)}
        tc["tables"]["full"].copy_(torch.from_numpy(table))
    jl, _, prod = jm.forward(jp, {"tokens": jnp.asarray(toks)}, remat=False, want_cache=True)
    jc = jm.write_prefill(jc, prod, jnp.asarray(lanes), jnp.asarray(lens), jlay)
    tl, tprod = tmodel.forward(tp, tcfg, torch.from_numpy(toks), want_cache=True)
    tmodel.write_prefill(tc, tcfg, tprod, torch.from_numpy(lanes).long(),
                         torch.from_numpy(lens), tlay)
    _close(tl, jl)
    return jm, jp, jc, jlay, tp, tc, tlay, rng.integers(0, tcfg.vocab, (3, 2))


def test_prefill_then_decode_steps_slab(setup):
    _, tcfg, _ = setup
    jm, jp, jc, jlay, tp, tc, tlay, feed = _prefilled(setup, "slab")
    for name in ("ckv", "krope"):  # the prefilled latents, lane by lane
        for lane, ln in enumerate(tc["len"].tolist()):  # the port's pad rows are dead
            _close(tc["body"]["sb_0"][name][:, lane, :ln], jc["body"]["sb_0"][name][:, lane, :ln])
            _close(tc["head_0"][name][lane, :ln], jc["head_0"][name][lane, :ln])
    for step in feed:
        jl, jc = jm.decode_step(jp, jnp.asarray(step, jnp.int32), jc, jlay)
        tl, tc = tmodel.decode_step(tp, tcfg, torch.from_numpy(step).int(), tc, tlay)
        _close(tl, jl)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_paged_absorbed_decode_matches_the_reference_kernel_route(setup):
    """The port's paged decode always takes the absorbed latent route; the
    reference takes it on its kernel route (Pallas in interpret mode)."""
    _, tcfg, _ = setup
    jm, jp, jc, jlay, tp, tc, tlay, feed = _prefilled(setup, "paged")
    with jdispatch.force_mode("interpret"):
        for step in feed:
            jl, jc = jm.decode_step(jp, jnp.asarray(step, jnp.int32), jc, jlay)
            tl, tc = tmodel.decode_step(tp, tcfg, torch.from_numpy(step).int(), tc, tlay)
            _close(tl, jl)
    for name in ("ckv", "krope"):  # the pages every write landed on (sink page cut)
        _close(tlay.pool_view(tc["head_0"][name]), jc["head_0"][name])
        _close(tc["body"]["sb_0"][name][:, : tlay.num_pages], jc["body"]["sb_0"][name])


def test_paged_latent_view_equals_the_slab(setup):
    """The latents that prefill and one decode ``write`` put on the pool,
    gathered through its scattered tables, equal what the slab stores for
    the same writes."""
    _, tcfg, _ = setup
    _, _, _, _, _, pc, play, _ = _prefilled(setup, "paged")
    _, _, _, _, _, sc, slay, _ = _prefilled(setup, "slab")
    rng = np.random.default_rng(5)
    new = {name: torch.from_numpy(rng.standard_normal((2, w)).astype(np.float32))
           for name, w in (("ckv", tcfg.mla.kv_lora), ("krope", tcfg.mla.rope_head_dim))}
    pos = sc["len"]
    play.write(pc["head_0"], new, pos, pc["tables"])
    slay.write(sc["head_0"], new, pos, None)
    phys = pc["tables"]["full"].long().clamp(max=play.num_pages - 1)
    for name in new:
        p_view = pc["head_0"][name][phys].flatten(1, 2)
        for lane, ln in enumerate((pos + 1).tolist()):
            assert torch.equal(p_view[lane, :ln], sc["head_0"][name][lane, :ln])


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_greedy_streams_match_jax(setup, layout):
    """Three ragged requests over two lanes (slot reuse, mixed budgets)."""
    jcfg, tcfg, t = setup
    jp, tp = t["compressed"]
    reqs = list(zip(prompts(3, tcfg.vocab), [6, 4, 5]))
    kw = dict(max_batch=2, max_len=24, seed=0)
    if layout == "paged":
        kw.update(num_pages=12, page_size=4)
    jeng = JaxEngine(TransformerLM(jcfg), jp, **kw)
    teng = DecodeEngine(tcfg, tp, device="cpu", **kw)
    streams = []
    for eng, sp in ((jeng, JaxSampling), (teng, SamplingParams)):
        uids = [eng.submit(p, sp(max_new_tokens=n)) for p, n in reqs]
        res = eng.run()
        streams.append([res[u].tokens for u in uids])
    for (p, _), a, b in zip(reqs, streams[1], streams[0]):
        assert_streams_agree(tcfg, tp, p, a, b)
    assert teng.kv_cache_bytes() == sum(
        x.numel() * x.element_size() for name, x in tree_items(teng.cache)
        if name.split("/")[0] in ("head_0", "body"))


def test_carry_over_keeps_every_leaf(setup):
    """Every leaf name and shape of the JAX trees; compressed 4-D expert
    stacks ``(L, E, Kc, O)`` bit for bit."""
    _, _, t = setup
    for kind in ("dense", "compressed"):
        jtree = dict(tree_items(t[kind][0]))
        ttree = dict(tree_items(t[kind][1]))
        assert sorted(ttree) == sorted(jtree)
        for name, leaf in ttree.items():
            ref = jtree[name]
            if isinstance(leaf, CompressedTensor):
                assert leaf.values.shape == ref.values.shape and leaf.shape == tuple(ref.shape)
                assert (leaf.n, leaf.m, leaf.group_axis, leaf.pad) == (
                    ref.n, ref.m, ref.group_axis, ref.pad)
                assert np.array_equal(leaf.values.numpy().view(np.int32),
                                      np.asarray(ref.values).view(np.int32))
                assert np.array_equal(leaf.indices.numpy(), np.asarray(ref.indices))
            else:
                assert tuple(leaf.shape) == ref.shape
                assert np.array_equal(leaf.numpy().view(np.int32), np.asarray(ref).view(np.int32))
    w = t["compressed"][1]["body"]["sb_0"]["moe"]["w_down_e"]
    assert w.values.dim() == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compress", [True, False])
def test_streamed_export_equals_whole_tree(dtype, compress):
    """``export_compressed`` (leaf by leaf, stacked leaves slice by slice,
    consuming its input) is bit-identical to ``compress_params`` of
    ``export_sparse``, and its report to ``compression_report``."""
    tcfg = dataclasses.replace(configs(ARCH)[1], param_dtype=dtype)
    recipe = tcore.make_recipe("step", tcore.SparsityConfig(default=tcore.NMSparsity(2, 4)))
    params = tmodel.init_params(tcfg, seed=3, device="cpu")
    sparse = recipe.export_sparse(params)
    whole = compress_params(sparse, recipe.sparsity) if compress else sparse
    streamed, rep = export_compressed(params, recipe, compress=compress)
    assert params == {}  # consumed
    ref = dict(tree_items(whole))
    assert sorted(dict(tree_items(streamed))) == sorted(ref)
    for name, leaf in tree_items(streamed):
        pairs = ([(leaf.values, ref[name].values), (leaf.indices, ref[name].indices)]
                 if isinstance(leaf, CompressedTensor) else [(leaf, ref[name])])
        assert isinstance(leaf, CompressedTensor) == isinstance(ref[name], CompressedTensor)
        for a, b in pairs:
            assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
    assert rep == compression_report(sparse, compress_params(sparse, recipe.sparsity))
