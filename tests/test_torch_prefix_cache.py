"""The prefix cache in the port (``serving.prefix_cache.PrefixIndex``, the
pool's shared pages and copy-on-write, ``DecodeEngine(prefix_cache=True)``),
held against the JAX package on the reduced gpt2-paper and DeepSeek-V2-Lite
(2 layers: its dense first and one MoE layer) in f32.

- The pool: the reference's random churn (admissions that share a live
  lane's prefix, decode growth that forks shared pages, releases, copy
  drains) run on both pools op for op gives the same page ids, refcounts,
  tables, ``pending_copies`` and fork counts after every op, and an empty
  pool at the end; the copy-on-write pin; ``apply_pending`` copies every
  K/V (or latent) leaf and scale plane in place, equal to the reference's
  copies exactly.
- ``PrefixIndex``: match, insert, evict and clear, and a partial entry
  dominated by a longer one, give the reference's results and references.
- The engine, against the reference engine with ``prefix_cache=True`` on
  the same weights: a second wave sharing the first wave's 12-token head
  hits the index (fp and int8 pools, gpt2 and DeepSeek), with chunked
  prefill and K steps, and under the device scheduler whose refills
  bypass the index; greedy streams equal the reference's and the cold
  (index-less) engine's except where the top-2 margin is under
  ``torch_parity.MARGIN`` (1e-2 on int8 pages, whose codes the two packages
  may round one step apart and which a hit's tail reads where a cold
  prefill reads fp K/V); the hit, token and fork counts equal; no page
  or reference left after ``clear()``.  The refusals (a slab, a window
  table, recurrent layers) warn; the CLI's ``--prefix-cache`` and
  ``--shared-prefix``.
"""
import dataclasses
import io
import json
import random
import warnings
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import TransformerLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SamplingParams as JaxSampling
from repro.serving.kv_pool import PagedKVPool as JaxPool
from repro.serving.prefix_cache import PrefixIndex as JaxIndex
from repro_torch.launch import serve as launch_serve
from repro_torch.serving import DecodeEngine, PagedKVPool, PrefixIndex, SamplingParams
from repro_torch.utils.tree import tree_items
from torch_parity import MARGIN, assert_streams_agree, configs, port_tree, trees

ARCHS = {"gpt2": ("gpt2-paper", {}), "deepseek": ("deepseek-v2-lite-16b", {"n_layers": 2})}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops at the reduced sizes: one intra-op thread runs them
    faster and keeps them off the cores of other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setups():
    """Each arch's ``(jcfg, tcfg, (jax tree, port tree))``, compressed,
    built on first use."""
    built = {}

    def get(name):
        if name not in built:
            arch, over = ARCHS[name]
            jcfg, tcfg, t = trees(arch=arch, **over)
            built[name] = (jcfg, tcfg, t["compressed"])
        return built[name]

    return get


def _pools(arch="gpt2", quant=False, **kw):
    """The two packages' pools over one reduced config (no weights needed)."""
    name, over = ARCHS[arch]
    jcfg, tcfg = configs(name, **over)
    kw = {"max_batch": 4, "max_len": 32, "num_pages": 24, "page_size": 4, "quant": quant, **kw}
    return JaxPool(TransformerLM(jcfg), **kw), PagedKVPool(tcfg, device="cpu", **kw)


def _same_state(jp, tp):
    assert tp._free == jp._free
    np.testing.assert_array_equal(tp._ref, jp._ref)
    np.testing.assert_array_equal(tp._pt["full"], jp._pt_full)
    assert tp._pages["full"] == jp._full_pages
    assert tp.pending_copies == jp.pending_copies
    assert (tp.cow_copies, tp.shared_pages, tp.free_pages) == (
        jp.cow_copies, jp.shared_pages, jp.free_pages)
    assert tp.free_pages + tp.used_pages == tp.layout.num_pages
    assert tp.used_pages == int((tp._ref > 0).sum())


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def test_pool_churn_matches_the_reference():
    """The reference's churn (``tests/test_prefix_cache.py:102``): 300
    random ops on both pools, the same state after each."""
    jp, tp = _pools()
    rng = random.Random(7)
    lens: dict[int, int] = {}  # lane -> cached length (next write position)
    for _ in range(300):
        op = rng.random()
        idle = [lane for lane in range(tp.max_batch) if lane not in lens]
        live = sorted(lens)
        if op < 0.40 and idle:
            lane, plen = rng.choice(idle), rng.randint(2, 16)
            shared, shared_len = (), 0
            donors = [d for d in live if lens[d] >= 2]
            if donors and rng.random() < 0.6:
                d = rng.choice(donors)
                shared_len = rng.randint(1, min(lens[d], plen) - 1)
                full, tail = tp.prompt_pages(d, shared_len)
                assert (full, tail) == jp.prompt_pages(d, shared_len)
                shared = tuple(full + ([tail] if tail is not None else []))
            ok = tp.alloc_prefill(lane, plen, shared_full=shared, shared_len=shared_len)
            assert ok == jp.alloc_prefill(lane, plen, shared_full=shared, shared_len=shared_len)
            if ok:
                lens[lane] = plen
        elif op < 0.75 and live:
            lane, k = rng.choice(live), rng.randint(1, 3)
            if lens[lane] + k > tp.max_len:
                tp.release(lane), jp.release(lane)
                del lens[lane]
            elif tp.ensure_steps(lane, lens[lane], k):
                assert jp.ensure_steps(lane, lens[lane], k)
                lens[lane] += k
            else:  # pool full: all or nothing, preempt the lane
                assert not jp.ensure_steps(lane, lens[lane], k)
                tp.release(lane), jp.release(lane)
                del lens[lane]
        elif op < 0.9 and live:
            lane = rng.choice(live)
            tp.release(lane), jp.release(lane)
            del lens[lane]
        elif tp.pending_copies:
            tp.apply_pending()
            jp.cache = jp.apply_pending(jp.cache)
            assert not tp.pending_copies
        _same_state(jp, tp)
    for lane in list(lens):
        tp.release(lane), jp.release(lane)
    tp.apply_pending()
    jp.cache = jp.apply_pending(jp.cache)
    _same_state(jp, tp)
    assert tp.free_pages == tp.layout.num_pages and (tp._ref == 0).all()
    assert tp.cow_copies > 0  # the churn forked pages


def test_cow_pins_the_source_until_the_copy_lands():
    """A forked page's source stays allocated, held by the pending copy
    alone, until ``apply_pending`` lands the copy, even after every lane
    released it."""
    _, tp = _pools(max_batch=2, num_pages=12)
    assert tp.alloc_prefill(0, 8)  # pages for 0..7 + the decode page
    full, _ = tp.prompt_pages(0, 6)  # one whole page and a boundary inside the next
    assert tp.alloc_prefill(1, 9, shared_full=tuple(full + [tp._pages["full"][0][1]]),
                            shared_len=6)
    assert tp.cow_copies == 1 and len(tp.pending_copies) == 1
    src, dst = tp.pending_copies[0]
    tp.release(0), tp.release(1)
    assert tp._ref[src] == 1  # the pin alone
    tp.apply_pending()
    assert tp._ref[src] == 0 and tp._ref[dst] == 0
    assert tp.free_pages == tp.layout.num_pages


def _pool_leaves(jc, tc, stacked=False):
    """``(jax leaf, port leaf cut to the reference's pages)`` of every page
    pool leaf of two caches (the port's pools end with a sink page)."""
    for name, t in tc.items():
        if name in ("len", "tables"):
            continue
        if isinstance(t, dict):
            yield from _pool_leaves(jc[name], t, stacked or name == "body")
            continue
        n = jc[name].shape[1 if stacked else 0]
        yield jc, name, (t[:, :n] if stacked else t[:n])


@pytest.mark.parametrize("arch,quant", [("gpt2", False), ("gpt2", True), ("deepseek", True)],
                         ids=["gpt2-fp", "gpt2-int8", "deepseek-int8"])
def test_apply_pending_copies_every_leaf_in_place(arch, quant):
    """The same random contents in both pools, then forks (a shared partial
    page at admission, then a write into a page the other lane shares):
    after ``apply_pending`` every leaf and scale plane equals the
    reference's exactly, at the address it had."""
    jp, tp = _pools(arch, quant, max_batch=3)
    rng = np.random.default_rng(0)
    for jc, name, t in _pool_leaves(jp.cache, tp.cache):
        fill = (rng.integers(-127, 128, t.shape) if t.dtype == torch.int8
                else rng.standard_normal(t.shape))
        t.copy_(torch.from_numpy(fill).to(t.dtype))
        jc[name] = jnp.asarray(t.numpy())
    ptrs = {name: x.data_ptr() for name, x in tree_items(tp.cache)}
    for pool in (jp, tp):
        assert pool.alloc_prefill(0, 10)
        full, tail = pool.prompt_pages(0, 10)
        assert pool.alloc_prefill(1, 14, shared_full=tuple(full + [tail]), shared_len=10)
        assert pool.ensure_steps(0, 10, 2)  # lane 0 writes into the page lane 1 shares
    assert tp.pending_copies == jp.pending_copies and len(tp.pending_copies) == 2
    tp.apply_pending()
    jp.cache = jp.apply_pending(jp.cache)
    _same_state(jp, tp)
    assert all(x.data_ptr() == ptrs[name] for name, x in tree_items(tp.cache))
    for jc, name, t in _pool_leaves(jp.cache, tp.cache):
        np.testing.assert_array_equal(t.numpy(), np.asarray(jc[name]), err_msg=name)


# ---------------------------------------------------------------------------
# the radix index
# ---------------------------------------------------------------------------


def test_prefix_index_matches_the_reference():
    """The reference's index tests (``tests/test_prefix_cache.py:183,223``)
    on both packages: every match, the entries and the pool references
    equal."""
    jp, tp = _pools(max_batch=2, num_pages=16)
    ji, ti = JaxIndex(jp, 4), PrefixIndex(tp, 4)
    prompt = list(range(10))  # 2 whole pages + a 2-token tail
    for pool in (jp, tp):
        assert pool.alloc_prefill(0, 10)
    full, tail = tp.prompt_pages(0, 10)
    for idx in (ji, ti):
        idx.insert(prompt, full, tail, 2)
    assert ti.pages == ji.pages == 3 and all(tp._ref[p] == 2 for p in full)
    # the whole entry; the first page; at most len - 1 tokens; nothing
    for q, want in ((prompt + [99], (10, tuple(full + [tail]))),
                    (list(range(4)) + [77, 78, 79, 80, 81], (4, tuple(full[:1]))),
                    (list(range(8)), (4, tuple(full[:1]))), ([55, 56, 57, 58, 59], (0, ()))):
        assert ti.match(q) == ji.match(q) == want
    for idx in (ji, ti):
        idx.insert(prompt, full, tail, 2)  # a duplicate changes nothing
    _same_state(jp, tp)
    for pool in (jp, tp):
        pool.release(0)
    used = tp.used_pages
    assert ti.evict(used) == ji.evict(used) == used and ti.pages == 0
    assert (ti.hits, ti.hit_tokens, ti.lookups, ti.evictions) == (
        ji.hits, ji.hit_tokens, ji.lookups, ji.evictions)
    _same_state(jp, tp)
    # a longer partial entry of a node replaces the shorter one it extends
    for pool in (jp, tp):
        assert pool.alloc_prefill(0, 2) and pool.alloc_prefill(1, 3)
    t0, t1 = tp.prompt_pages(0, 2)[1], tp.prompt_pages(1, 3)[1]
    for idx in (ji, ti):
        idx.insert([1, 2], [], t0, 2)
        idx.insert([1, 2, 3], [], t1, 3)
    assert ti.pages == ji.pages == 1
    assert ti.match([1, 2, 3, 9]) == ji.match([1, 2, 3, 9]) == (3, (t1,))
    for pool, idx in ((jp, ji), (tp, ti)):
        pool.release(0), pool.release(1)
        idx.clear()
    _same_state(jp, tp)
    assert tp.free_pages == tp.layout.num_pages


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _waves(eng, waves, sampling=SamplingParams):
    """Submit and drain wave by wave, so the second wave can hit what the
    first indexed; the streams and finish reasons."""
    toks, reasons = [], []
    for prompts in waves:
        uids = [eng.submit(p, sampling(max_new_tokens=5)) for p in prompts]
        res = eng.run()
        toks += [res[u].tokens for u in uids]
        reasons += [res[u].finish_reason for u in uids]
    return toks, reasons


def _shared_waves(vocab, head=12, tails=(3, 5, 2), seed=500):
    """Wave 1: one prompt; wave 2: the others, sharing its ``head``
    tokens."""
    h = np.random.default_rng(seed).integers(0, vocab, head).tolist()
    prompts = [h + np.random.default_rng(seed + 1 + i).integers(0, vocab, t).tolist()
               for i, t in enumerate(tails)]
    return [prompts[:1], prompts[1:]]


FORK_CASES = {
    "gpt2": ("gpt2", dict(seed=3)),
    "gpt2-int8": ("gpt2", dict(seed=3, kv_quant=True)),
    "deepseek": ("deepseek", dict(seed=3)),
    "gpt2-chunk-k4": ("gpt2", dict(seed=0, steps_per_dispatch=4, prefill_chunk=4)),
}


@pytest.mark.parametrize("case", list(FORK_CASES))
def test_prefix_hits_match_cold_and_the_reference(setups, case):
    arch, kw = FORK_CASES[case]
    jcfg, tcfg, (jparams, tparams) = setups(arch)
    head, tails = (11, (4, 6)) if "chunk" in case else (12, (3, 5, 2))
    waves = _shared_waves(tcfg.vocab, head, tails)
    kw = dict(max_batch=2, max_len=32, num_pages=32, page_size=4, **kw)
    cold = _waves(DecodeEngine(tcfg, tparams, device="cpu", **kw), waves)
    eng = DecodeEngine(tcfg, tparams, device="cpu", prefix_cache=True, **kw)
    warm = _waves(eng, waves)
    jeng = JaxEngine(TransformerLM(jcfg), jparams, prefix_cache=True, **kw)
    ref = _waves(jeng, waves, JaxSampling)
    margin = 1e-2 if kw.get("kv_quant") else MARGIN
    prompts = [p for w in waves for p in w]
    for p, a, b, c in zip(prompts, warm[0], cold[0], ref[0]):
        assert_streams_agree(tcfg, tparams, p, a, b, margin=margin)
        assert_streams_agree(tcfg, tparams, p, a, c, margin=margin)
    assert warm[1] == cold[1] == ref[1]
    n_hits = len(waves[1])  # each matches the head's whole pages
    assert eng.prefix_hits == n_hits and eng.prefix_hit_tokens == n_hits * (head // 4 * 4)
    st, jst = eng.stats(), jeng.stats()
    keys = ("prefix_hits", "prefix_hit_tokens", "prefix_hit_rate", "cow_copies",
            "prefix_indexed_pages", "shared_pages", "prefill_chunks", "prefill_batches",
            "used_pages")
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    assert st["prefix_cache"] and st["cow_copies"] == eng.pool.cow_copies > 0
    eng._prefix.clear()  # every lane is done: the index holds every page left
    assert eng.pool.free_pages == eng.pool.layout.num_pages and (eng.pool._ref == 0).all()


def test_refills_with_shared_prefix_pages(setups):
    """The reference's ``test_refill_with_prefix_cache_shared_pages``: staged
    refills write fresh pages while host admissions share cached prefix
    pages; streams equal the index-less sync engine's except at f32
    near-ties."""
    _, tcfg, (_, tparams) = setups("gpt2")
    head = np.random.default_rng(7).integers(0, tcfg.vocab, 6).tolist()
    prompts = [head + np.random.default_rng(200 + r).integers(0, tcfg.vocab, 2 + r % 3).tolist()
               for r in range(6)]
    sps = [SamplingParams(max_new_tokens=6 + r % 4) for r in range(6)]

    def run(**kw):
        eng = DecodeEngine(tcfg, tparams, device="cpu", max_batch=2, max_len=32, seed=11,
                           num_pages=96, page_size=2, **kw)
        uids = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
        res = eng.run()
        return [res[u].tokens for u in uids], eng

    base, _ = run(steps_per_dispatch=2)
    got, eng = run(prefix_cache=True, max_steps_per_dispatch=5, staged_lanes=1,
                   async_stream=True)
    for p, a, b in zip(prompts, got, base):
        assert_streams_agree(tcfg, tparams, p, a, b)
    assert eng.refills > 0 and eng.prefix_hits > 0  # host admissions still hit the index
    eng._prefix.clear()
    assert eng.pool.free_pages == eng.pool.layout.num_pages


def test_prefix_cache_refused_without_an_append_only_table(setups):
    """The reference's refusals (``tests/test_prefix_cache.py:286``): a
    recurrent arch's pool, a windowed pool and the slab warn and serve
    without the index."""
    rcfg, rp = port_tree("recurrentgemma-9b")
    _, tcfg, (_, tp) = setups("gpt2")
    wcfg = dataclasses.replace(tcfg, local_window=8)
    for cfg, params, kw in ((rcfg, rp, dict(num_pages=16, page_size=4)),
                            (wcfg, tp, dict(num_pages=16, page_size=4)), (tcfg, tp, {})):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            eng = DecodeEngine(cfg, params, max_batch=1, max_len=24, prefix_cache=True,
                               device="cpu", **kw)
        assert eng._prefix is None and "prefix_cache" not in eng.stats()
        assert any("prefix" in str(x.message).lower() for x in w)


def _cli(*extra):
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--device", "cpu", "--batch", "2", "--requests", "4",
                           "--prompt-len", "14", "--gen", "4", "--paged", "--page-size", "4",
                           *extra])
    return json.loads(buf.getvalue().strip().splitlines()[-1])["summary"]


def test_cli_prefix_cache_and_shared_prefix():
    """``--prefix-cache --shared-prefix 9`` on the CPU: the two requests
    after the first lane pair hit the shared head's 2 whole pages, a lane
    forks its indexed partial tail page at its first decode write, and the
    greedy streams equal the index-less run's (the CLI serves the bf16
    tree; these prompts part at no near-tie); the refusal without
    ``--paged``."""
    base = _cli("--shared-prefix", "9")
    got = _cli("--shared-prefix", "9", "--prefix-cache", "--prefill-chunk", "4")
    assert got["greedy_streams"] == base["greedy_streams"]
    assert (got["prefix_hits"], got["prefix_hit_tokens"]) == (2, 16)
    assert got["cow_copies"] > 0 and got["prefill_chunks"] > 0
    assert "prefix_hits" not in base and base["cow_copies"] == 0
    with pytest.raises(SystemExit, match="require --paged"):
        launch_serve.main(["--device", "cpu", "--prefix-cache"])
