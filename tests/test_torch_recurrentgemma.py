"""Reduced RecurrentGemma-9B (8 layers: (rec, rec, attn) stacked twice and
two trailing RG-LRU layers; local MQA with window 16) in the port, held
against the JAX package on the same f32 weights: ``forward`` logits;
exact-length prefill then decode steps on the slab (a rolling window slab)
and on the paged pool (the modular window table, ``page_size`` 4,
``max_len`` 40), with both packages' pools making the same calls and
holding the same tables, free list and evicted pages; greedy streams
against ``DecodeEngine(mesh=None)``; the engine's pool accounting through
preemptions; the streamed export; the serve CLI on the CPU.  Tolerance:
``torch_parity.LOGIT_TOL`` unless a test says otherwise."""
import io
import json
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import TransformerLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SamplingParams as JaxSampling
from repro.serving.kv_pool import PagedKVPool as JaxPool
from repro_torch import core as tcore
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as tmodel
from repro_torch.models.cache import SlabLayout
from repro_torch.serving import DecodeEngine, SamplingParams
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.sparse_infer import CompressedTensor, compress_params, export_compressed
from repro_torch.utils.tree import tree_items
from torch_parity import LOGIT_TOL, assert_streams_agree, configs, prompts, trees

ARCH = "recurrentgemma-9b"
LAYERS = dict(n_layers=8)  # the reference's reduced() gives 6 layers, and so no tail
MAX_LEN, PS = 40, 4


@pytest.fixture(scope="module")
def setup():
    return trees(arch=ARCH, **LAYERS)


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **LOGIT_TOL)


def test_plan_and_tree(setup):
    jcfg, tcfg, t = setup
    plan = tmodel.layer_plan(tcfg)
    assert (plan.head, plan.period, plan.n_body, plan.tail) == (
        (), ("rec", "rec", "attn"), 2, ("rec", "rec"))
    names = dict(tree_items(t["compressed"][1]))
    assert isinstance(names["tail_1/mixer/w_i_gate"], CompressedTensor)
    assert isinstance(names["body/sb_2/attn/wq"], CompressedTensor)
    assert names["body/sb_0/mixer/conv_w"].shape == (2, 4, 64)


@pytest.mark.parametrize("kind", ["dense", "compressed"])
def test_forward_logits(setup, kind):
    """27 tokens: past the window, through every layer kind."""
    jcfg, tcfg, t = setup
    jp, tp = t[kind]
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 27))
    jl, _, _ = TransformerLM(jcfg).forward(jp, {"tokens": jnp.asarray(toks)}, remat=False)
    tl, _ = tmodel.forward(tp, tcfg, torch.from_numpy(toks))
    _close(tl, jl)


def _layer_leaves(cache):
    """The cache leaves both packages name alike (not the tables)."""
    return {n: x for n, x in tree_items(cache) if not n.startswith("tables")}


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_prefill_then_decode_steps(setup, layout):
    """Two prompts prefilled at their exact lengths, 22 tokens (past the
    window) into lane 1 and 7 into lane 0, then 14 decode steps feeding
    the same tokens to both packages, which cross page boundaries and
    evict window pages.  Logits every step; the recurrent states, and on
    the slab the rolled window rows, after prefill and at the end; on the
    pool the tables, free list and evicted pages after every call."""
    jcfg, tcfg, t = setup
    jp, tp = t["compressed"]
    jm = TransformerLM(jcfg)
    rng = np.random.default_rng(1)
    seqs = {1: rng.integers(0, tcfg.vocab, 22), 0: rng.integers(0, tcfg.vocab, 7)}
    feed = rng.integers(0, tcfg.vocab, (14, 2))
    if layout == "paged":
        jpool = JaxPool(jm, max_batch=2, max_len=MAX_LEN, num_pages=16, page_size=PS)
        tpool = PagedKVPool(tcfg, max_batch=2, max_len=MAX_LEN, num_pages=16, page_size=PS,
                            device="cpu")
        jlay, tlay, jc, tc = jpool.layout, tpool.layout, jpool.cache, tpool.cache
        assert tlay.pages_win == jlay.pages_win == 5 and tlay.pages_full == 0

        def sync():
            np.testing.assert_array_equal(tpool._pt["win"], jpool._pt_win)
            assert tpool._free == jpool._free
            assert tpool.evicted_pages == jpool.evicted_pages
            jc["tables"] = jpool.device_tables()
            tpool.device_tables()
    else:
        jlay, tlay = None, SlabLayout(MAX_LEN)
        jc = jm.init_cache(2, MAX_LEN)
        tc = tmodel.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    for lane, seq in seqs.items():
        if layout == "paged":
            assert jpool.alloc_prefill(lane, len(seq)) and tpool.alloc_prefill(lane, len(seq))
            sync()
        lanes, lens = np.array([lane], np.int32), np.array([len(seq)], np.int32)
        jl, _, prod = jm.forward(jp, {"tokens": jnp.asarray(seq[None])}, remat=False,
                                 want_cache=True)
        jc = jm.write_prefill(jc, prod, jnp.asarray(lanes), jnp.asarray(lens), jlay)
        tl, tprod = tmodel.forward(tp, tcfg, torch.from_numpy(seq[None]), want_cache=True)
        tmodel.write_prefill(tc, tcfg, tprod, torch.from_numpy(lanes).long(),
                             torch.from_numpy(lens), tlay)
        _close(tl, jl)
    jleaves = _layer_leaves(jc)
    for name, x in _layer_leaves(tc).items():
        if layout == "slab" and name.startswith("body/sb_2"):  # the window slab (L, B, 16, ...)
            _close(x[:, 1], jleaves[name][:, 1])  # lane 1 holds positions 6..21, all live
            _close(x[:, 0, :7], jleaves[name][:, 0, :7])
        elif "state" in name or "conv" in name:
            _close(x, jleaves[name])
    for step in feed:
        if layout == "paged":
            for lane in (0, 1):
                pos = int(tc["len"][lane])
                assert jpool.ensure_steps(lane, pos, 1) and tpool.ensure_steps(lane, pos, 1)
            sync()
        jl, jc = jm.decode_step(jp, jnp.asarray(step, jnp.int32), jc, jlay)
        tl, tc = tmodel.decode_step(tp, tcfg, torch.from_numpy(step).int(), tc, tlay)
        _close(tl, jl)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    jleaves = _layer_leaves(jc)
    for name, x in _layer_leaves(tc).items():
        if "state" in name or "conv" in name or (layout == "slab" and "sb_2" in name):
            _close(x, jleaves[name])
    if layout == "paged":
        assert tpool.evicted_pages > 0


def _engines(setup, layout, k, **kw):
    jcfg, tcfg, t = setup
    jp, tp = t["compressed"]
    paged = dict(num_pages=kw.pop("num_pages", 24), page_size=PS) if layout == "paged" else {}
    common = dict(max_batch=2, max_len=MAX_LEN, seed=0, steps_per_dispatch=k, **paged)
    return (JaxEngine(TransformerLM(jcfg), jp, **common),
            DecodeEngine(tcfg, tp, device="cpu", **common))


def _run(eng, reqs, sp_cls):
    uids = [eng.submit(p, sp_cls(max_new_tokens=n)) for p, n in reqs]
    res = eng.run()
    return [res[u].tokens for u in uids], [res[u].finish_reason for u in uids]


@pytest.mark.parametrize("layout,k", [("slab", 1), ("slab", 4), ("paged", 1), ("paged", 4)])
def test_greedy_streams_match_jax(setup, layout, k):
    """Four requests of 5-26 prompt tokens over two lanes (slot reuse,
    prompts past the window, decodes that cross it), prefilled at exact
    lengths: token-equal wherever the top-2 margin clears
    ``torch_parity.MARGIN``; the same prefill batches and KV bytes read a
    step, and on the pool the same evicted pages."""
    _, tcfg, t = setup
    reqs = list(zip(prompts(4, tcfg.vocab, lo=5, step=7), [14, 9, 20, 12]))
    jeng, teng = _engines(setup, layout, k)
    jt, jr = _run(jeng, reqs, JaxSampling)
    tt, tr = _run(teng, reqs, SamplingParams)
    for (p, _), a, b in zip(reqs, tt, jt):
        assert_streams_agree(tcfg, t["compressed"][1], p, a, b)
    if tt == jt:
        assert tr == jr
        assert teng.stats()["kv_bytes_per_step"] == jeng.stats()["kv_bytes_per_step"]
    assert teng.prefill_batches == jeng.prefill_batches
    if layout == "paged":
        assert teng.pool.evicted_pages == jeng.pool.evicted_pages > 0
        assert teng.stats()["evicted_pages"] == teng.pool.evicted_pages
        assert "full" not in teng.cache["tables"] and teng.kernel_route() == "plain"


def test_pool_accounting_equal_step_for_step(setup):
    """A pool too small for three windowed lanes' worth: after every
    scheduling step the port's free pages, evicted pages and preemptions
    equal the JAX engine's, and no page leaks."""
    _, tcfg, _ = setup
    reqs = list(zip(prompts(3, tcfg.vocab, lo=14, step=5), [16, 16, 16]))
    jeng, teng = _engines(setup, "paged", 2, num_pages=9)
    for p, n in reqs:
        jeng.submit(p, JaxSampling(max_new_tokens=n))
        teng.submit(p, SamplingParams(max_new_tokens=n))
    pool = teng.pool
    while jeng.queue or any(jeng.slots):
        jeng.step()
        teng.step()
        held = sum(len(pool.lane_pages(i)) for i in range(teng.max_batch))
        assert pool.free_pages + held == pool.layout.num_pages
        assert pool._free == jeng.pool._free
        assert pool.evicted_pages == jeng.pool.evicted_pages
        assert teng.preemptions == jeng.preemptions
    assert not teng.queue and not any(teng.slots)
    assert teng.preemptions > 0 and pool.evicted_pages > 0
    assert pool.free_pages == pool.layout.num_pages


def test_live_kv_bytes_split_full_and_window(setup):
    """Windowed attention layers count at most the window's tokens a lane,
    the rest every token; with ``max_len`` under the window the layers
    page through the full table and count every token."""
    _, tcfg, t = setup
    tp = t["compressed"][1]
    row = 2 * 2 * tcfg.n_kv * tcfg.hd * 4  # k and v, 2 attn layers, f32
    for max_len, full_b, win_b in ((MAX_LEN, 0, row), (12, row, 0)):
        eng = DecodeEngine(tcfg, tp, max_batch=2, max_len=max_len, device="cpu")
        assert eng._kv_row_bytes() == (full_b, win_b)
    eng = DecodeEngine(tcfg, tp, max_batch=2, max_len=MAX_LEN, device="cpu")
    eng.submit(list(range(30)), SamplingParams(max_new_tokens=5))
    eng.step()
    assert eng.live_kv_bytes() == row * 16
    assert eng.stats()["kv_bytes_per_step"] == row * 16
    # k/v x layers x lanes x rows, then the 6 RG-LRU layers' f32 state (W)
    # and conv tail (3 x W) of each of the 2 lanes
    assert eng.kv_cache_bytes() == (2 * 2 * 2 * 16 * tcfg.hd * 4
                                    + 6 * 2 * (1 + 3) * tcfg.rglru.lru_width * 4)


@pytest.mark.parametrize("compress", [True, False])
def test_streamed_export_equals_whole_tree(compress):
    """``export_compressed`` of the port's own bf16 init is bit-identical
    to ``compress_params`` of ``export_sparse``."""
    import dataclasses

    tcfg = dataclasses.replace(configs(ARCH, **LAYERS)[1], param_dtype="bfloat16")
    recipe = tcore.make_recipe("step", tcore.SparsityConfig(default=tcore.NMSparsity(2, 4)))
    params = tmodel.init_params(tcfg, seed=3, device="cpu")
    sparse = recipe.export_sparse(params)
    whole = dict(tree_items(compress_params(sparse, recipe.sparsity) if compress else sparse))
    streamed, _ = export_compressed(params, recipe, compress=compress)
    assert sorted(dict(tree_items(streamed))) == sorted(whole)
    for name, leaf in tree_items(streamed):
        ref = whole[name]
        pairs = ([(leaf.values, ref.values), (leaf.indices, ref.indices)]
                 if isinstance(leaf, CompressedTensor) else [(leaf, ref)])
        for a, b in pairs:
            assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name


def test_serve_cli_on_the_cpu_takes_the_window_path():
    """``--arch recurrentgemma-9b --paged`` on the reduced model: the pool
    holds only the window table, evicts pages, and every request finishes."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        summary = launch_serve.main([
            "--device", "cpu", "--arch", ARCH, "--batch", "2", "--requests", "3",
            "--prompt-len", "20", "--gen", "6", "--paged", "--page-size", "4",
            "--steps-per-dispatch", "2"])
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == {"summary": summary}
    assert summary["n_requests"] == 3 and summary["generated_tokens"] == 18
    assert summary["evicted_pages"] > 0 and summary["kernel_route"] == "plain"
    assert all(len(s) == 6 for s in summary["greedy_streams"])
