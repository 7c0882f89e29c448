"""The port's device scheduler (``DecodeEngine(max_steps_per_dispatch=,
staged_lanes=, async_stream=)``, ``serving/device_loop.py``) on the CPU,
where its loop runs eagerly: the same gated iterations a CUDA graph holds
on the card.

Held against the port's own sync scheduler (the reference's
``tests/test_device_scheduler.py``, ported): greedy and sampled streams,
finish reasons, mid-loop EOS / budget / capacity freezes, refills under
pool pressure that preempts and resumes, async double-buffering with a
slow host fetch, fewer host syncs.  Held against the reference's device
scheduler on the same f32 weights: greedy streams, every scheduling
counter and the pool's free pages step for step.  Also ``reset_lanes``
against the reference's, the device-keyed draws (independence, their
frequencies, greedy rows), the MoE expert counts that replaced
``bincount``, and the serve CLI's three flags.

Tolerance: streams are equal token for token, except that a request
refilled inside the loop has its prompt fed token by token through the
decode step where the sync scheduler prefills it in one batched forward;
in f32 the two differ by about 1e-6 of a logit, so a greedy token of a
staged variant may part from the sync stream only where the top-2 margin
is under ``torch_parity.MARGIN`` (``assert_streams_agree``).
"""
import io
import json
import time
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import TransformerLM
from repro.models.model import reset_lanes as jax_reset_lanes
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SamplingParams as JaxSampling
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.serving import DecodeEngine, SamplingParams
from repro_torch.serving.sampling import draw_keys, sample_tokens
from torch_parity import assert_streams_agree, configs, port_tree, prompts, trees

DEVICE_VARIANTS = [
    dict(max_steps_per_dispatch=5),
    dict(max_steps_per_dispatch=5, staged_lanes=2),
    dict(max_steps_per_dispatch=5, staged_lanes=2, async_stream=True),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tests run many small ops at the reduced sizes: one intra-op
    thread runs them faster alone and keeps them from oversubscribing the
    cores beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    return trees()


def _mixed_load(vocab, n=6, gen=8, eos_id=-1):
    """More requests than lanes, greedy and sampled, staggered budgets."""
    ps = [np.random.default_rng(50 + r).integers(0, vocab, 2 + r % 4).tolist()
          for r in range(n)]
    sps = [SamplingParams(temperature=0.8, top_k=7, max_new_tokens=gen - r % 2, eos_id=eos_id)
           if r % 3 == 1 else SamplingParams(max_new_tokens=gen + r % 3, eos_id=eos_id)
           for r in range(n)]
    return ps, sps


def _run(tp, tcfg, ps, sps, **kw):
    kw = {"max_batch": 2, "max_len": 32, **kw}
    eng = DecodeEngine(tcfg, tp, seed=11, device="cpu", **kw)
    uids = [eng.submit(p, sp) for p, sp in zip(ps, sps)]
    res = eng.run()
    return ([res[u].tokens for u in uids], [res[u].finish_reason for u in uids]), eng


def _agree(tcfg, tp, ps, sps, base, got, staged):
    """``got`` equals ``base``; with staged refills, a greedy stream may
    part from it only at an f32 near-tie (module docstring)."""
    if not staged or got == base:
        assert got == base
        return
    for p, sp, a, b, ra, rb in zip(ps, sps, base[0], got[0], base[1], got[1]):
        if sp.temperature > 0:
            assert a == b and ra == rb
        else:
            assert_streams_agree(tcfg, tp, p, a, b)
            if a == b:
                assert ra == rb


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_scheduler_equivalence_compressed(setup, paged):
    _, tcfg, t = setup
    tp = t["compressed"][1]
    ps, sps = _mixed_load(tcfg.vocab)
    pkw = dict(num_pages=64, page_size=4) if paged else {}
    base, _ = _run(tp, tcfg, ps, sps, steps_per_dispatch=4, **pkw)
    assert any(sp.temperature > 0 for sp in sps) and len(set(map(len, base[0]))) > 1
    for variant in DEVICE_VARIANTS:
        got, eng = _run(tp, tcfg, ps, sps, **variant, **pkw)
        _agree(tcfg, tp, ps, sps, base, got, variant.get("staged_lanes"))
        st = eng.stats()
        assert st["scheduler"] == "device" and st["device_loop"] == "eager"
        if variant.get("staged_lanes"):
            assert eng.refills > 0  # swaps happened inside the loop
        if variant.get("async_stream"):
            assert eng.dispatches == 2 * eng.cycles  # double-buffered
        assert st["loop_iterations"] == 5 * eng.dispatches
        assert st["gated_iterations"] == st["loop_iterations"] - st["decode_steps"] > 0


def test_run_until_stop_amortizes_host_syncs(setup):
    """Uniform long generations: the loop runs to its bound, so the device
    scheduler syncs the host fewer times than the sync engine does."""
    _, tcfg, t = setup
    tp = t["compressed"][1]
    ps = prompts(2, tcfg.vocab, lo=3, step=0, seed=70)
    sps = [SamplingParams(max_new_tokens=12) for _ in ps]
    base, sync_eng = _run(tp, tcfg, ps, sps, steps_per_dispatch=4)
    got, dev_eng = _run(tp, tcfg, ps, sps, max_steps_per_dispatch=12)
    assert got == base
    assert dev_eng.stats()["host_syncs"] < sync_eng.stats()["host_syncs"]
    assert dev_eng.stats()["host_syncs"] == dev_eng.cycles
    assert sync_eng.stats()["block_fetches"] == sync_eng.dispatches


def test_midloop_eos_freeze_matches_sync(setup):
    """An EOS id taken off a baseline stream fires inside the loop; every
    variant finishes that lane as the sync engine does."""
    _, tcfg, t = setup
    tp = t["compressed"][1]
    ps = prompts(3, tcfg.vocab, lo=3, step=0, seed=90)
    sps = [SamplingParams(max_new_tokens=10) for _ in ps]
    (toks, _), _ = _run(tp, tcfg, ps, sps, steps_per_dispatch=1)
    j = next(j for j in range(2, 10) if toks[0][j] not in toks[0][:j])
    eos = toks[0][j]  # fires mid-loop for K = 5
    sps = [SamplingParams(max_new_tokens=10, eos_id=eos) for _ in ps]
    base, _ = _run(tp, tcfg, ps, sps, steps_per_dispatch=1)
    assert base[1][0] == "eos" and len(base[0][0]) == j
    for variant in DEVICE_VARIANTS:
        got, _ = _run(tp, tcfg, ps, sps, **variant)
        _agree(tcfg, tp, ps, sps, base, got, variant.get("staged_lanes"))


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_midloop_capacity_and_budget_freezes(setup, paged):
    """A tight max_len: lanes hit the logical capacity inside the loop
    (refilled lanes whose prompt + budget overrun it too), others
    exhaust budgets of different parities."""
    _, tcfg, t = setup
    tp = t["compressed"][1]
    ps = [np.random.default_rng(120 + r).integers(0, tcfg.vocab, 4 + r).tolist()
          for r in range(5)]
    sps = [SamplingParams(max_new_tokens=3 + 4 * r) for r in range(5)]
    pkw = dict(num_pages=64, page_size=2) if paged else {}
    base, _ = _run(tp, tcfg, ps, sps, max_len=14, steps_per_dispatch=3, **pkw)
    assert "cache_full" in base[1] and "length" in base[1]
    for variant in DEVICE_VARIANTS:
        got, _ = _run(tp, tcfg, ps, sps, max_len=14, **variant, **pkw)
        _agree(tcfg, tp, ps, sps, base, got, variant.get("staged_lanes"))


def test_refill_under_pool_pressure_preempts_and_resumes(setup):
    """An undersized pool: staging backs off where ``stage_alloc`` cannot
    reserve, lanes preempt and resume from prompt + generated prefix, and
    the streams are the sync scheduler's (which never preempts here)."""
    _, tcfg, t = setup
    tp = t["compressed"][1]
    ps = prompts(6, tcfg.vocab)
    sps = [SamplingParams(max_new_tokens=n) for n in (6, 4, 7, 5, 8, 3)]
    pkw = dict(num_pages=10, page_size=4, max_len=24)
    base, sync_eng = _run(tp, tcfg, ps, sps, steps_per_dispatch=4, **pkw)
    got, eng = _run(tp, tcfg, ps, sps, max_steps_per_dispatch=5, staged_lanes=2,
                    async_stream=True, **pkw)
    _agree(tcfg, tp, ps, sps, base, got, True)
    assert eng.preemptions > 0 and eng.refills > 0
    assert got[1] == ["length"] * 6
    assert eng.pool.free_pages == eng.pool.layout.num_pages  # no page leaked


def test_async_stream_forced_slow_fetch_keeps_order(setup):
    """A slow host fetch: the second dispatch of each cycle is long done
    when the first's block arrives; blocks still replay in launch order."""
    _, tcfg, t = setup
    tp = t["compressed"][1]
    ps, sps = _mixed_load(tcfg.vocab, n=5)
    base, _ = _run(tp, tcfg, ps, sps, steps_per_dispatch=4)
    eng = DecodeEngine(tcfg, tp, max_batch=2, max_len=32, seed=11, device="cpu",
                       max_steps_per_dispatch=5, staged_lanes=2, async_stream=True)
    fetched, fetch = [], eng._fetch_block

    def slow_fetch(w):
        time.sleep(0.02)
        fetched.append(w)
        return fetch(w)

    eng._fetch_block = slow_fetch
    uids = [eng.submit(p, sp) for p, sp in zip(ps, sps)]
    res = eng.run()
    _agree(tcfg, tp, ps, sps, base, ([res[u].tokens for u in uids],
                                      [res[u].finish_reason for u in uids]), True)
    assert len(fetched) == eng.dispatches == 2 * eng.cycles
    assert fetched == [0, 1] * eng.cycles
    st = eng.stats()
    assert st["block_fetches"] == eng.dispatches
    assert st["itl_ms_p99"] >= st["itl_ms_p50"] > 0


@pytest.mark.parametrize("num_pages", [32, 10], ids=["roomy", "preempting"])
def test_matches_the_reference_device_scheduler(setup, num_pages):
    """The reference's ``DecodeEngine(max_steps_per_dispatch=5,
    staged_lanes=2, async_stream=True)`` and the port's on the same f32
    weights and paged pool, stepped together: the pool's free pages equal
    after every cycle (staging, adoption, release and preemption make the
    same calls), every scheduling counter equal at the end, greedy streams
    equal except at f32 near-ties."""
    jcfg, tcfg, t = setup
    jp, tp = t["compressed"]
    ps = prompts(6, tcfg.vocab)
    budgets = (6, 4, 7, 5, 8, 3)
    common = dict(max_batch=2, max_len=24, seed=0, num_pages=num_pages, page_size=4,
                  max_steps_per_dispatch=5, staged_lanes=2, async_stream=True)
    jeng = JaxEngine(TransformerLM(jcfg), jp, **common)
    teng = DecodeEngine(tcfg, tp, device="cpu", **common)
    for p, n in zip(ps, budgets):
        jeng.submit(p, JaxSampling(max_new_tokens=n))
        teng.submit(p, SamplingParams(max_new_tokens=n))
    jres, tres = {}, {}
    while jeng.queue or any(jeng.slots):
        jres.update({r.uid: r for r in jeng.step()})
        tres.update({r.uid: r for r in teng.step()})
        assert teng.pool.free_pages == jeng.pool.free_pages
        assert [s is None for s in teng.slots] == [s is None for s in jeng.slots]
    assert not teng.queue and not any(teng.slots)
    keys = ("decode_steps", "dispatches", "cycles", "refills", "block_fetches", "preemptions",
            "admitted", "host_syncs")
    jst, tst = jeng.stats(), teng.stats()
    assert {k: tst[k] for k in keys} == {k: jst[k] for k in keys}
    assert tst["refills"] > 0
    assert (tst["preemptions"] > 0) == (num_pages == 10)
    for uid, p in enumerate(ps):
        assert_streams_agree(tcfg, tp, p, tres[uid].tokens, jres[uid].tokens)


def test_reset_lanes_matches_the_reference():
    """``reset_lanes`` on a reduced RecurrentGemma cache (stacked body and
    unstacked tail RG-LRU layers, attention beside them), filled with the
    same random values in both packages, gives the reference's cache
    exactly: the masked lanes' ``state`` and ``conv`` rows zero, every
    other value kept."""
    jcfg, tcfg = configs("recurrentgemma-9b", n_layers=8)
    jc = TransformerLM(jcfg).init_cache(3, 16)
    tc = tmodel.init_cache(tcfg, 3, 16, device="cpu")
    rng = np.random.default_rng(0)
    filled = {}

    def fill(j, t, path):
        if isinstance(t, dict):
            return {k: fill(j[k], t[k], f"{path}/{k}") for k in t}
        if not t.is_floating_point():
            return j
        x = rng.standard_normal(t.shape).astype(np.float32)
        filled[path] = x
        t.copy_(torch.from_numpy(x))
        return jnp.asarray(x, j.dtype)

    jc = fill(jc, tc, "")
    mask = np.array([True, False, True])
    jout = jax_reset_lanes(jcfg, jc, jnp.asarray(mask))
    tmodel.reset_lanes(tcfg, tc, torch.from_numpy(mask))

    def leaves(j, t, path=""):
        if isinstance(t, dict):
            for k in t:
                yield from leaves(j[k], t[k], f"{path}/{k}")
        else:
            yield path, np.asarray(j, np.float32), t.float().numpy()

    rec = 0
    for path, j, t in leaves(jout, tc):
        np.testing.assert_array_equal(t, j, err_msg=path)
        if path.endswith(("/state", "/conv")):
            rec += 1
            lanes = (slice(None),) * (1 if path.startswith("/body") else 0)
            assert not t[lanes + (mask,)].any()
            np.testing.assert_array_equal(t[lanes + (~mask,)], filled[path][lanes + (~mask,)])
        elif path in filled:
            np.testing.assert_array_equal(t, filled[path])
    assert rec == 8  # state and conv of body sb_0, sb_1 and tail_0, tail_1


def test_recurrent_arch_on_the_rolling_slab_and_the_window_pool():
    """Reduced RecurrentGemma (window 16, max_len 40): lanes run past the
    window, so the slab rolls and the pool's window table wraps; the gated
    iterations must neither roll the slab nor advance the RG-LRU state,
    and refills zero it.  Streams equal the sync scheduler's."""
    tcfg, tp = port_tree("recurrentgemma-9b", n_layers=8)
    ps = [np.random.default_rng(7 + r).integers(0, tcfg.vocab, 12 + 3 * r).tolist()
          for r in range(5)]
    sps = [SamplingParams(max_new_tokens=n) for n in (12, 7, 10, 9, 6)]
    for pkw in ({}, dict(num_pages=48, page_size=4)):
        base, _ = _run(tp, tcfg, ps, sps, max_len=40, steps_per_dispatch=4, **pkw)
        for variant in DEVICE_VARIANTS[::2]:
            got, eng = _run(tp, tcfg, ps, sps, max_len=40, **variant, **pkw)
            _agree(tcfg, tp, ps, sps, base, got, variant.get("staged_lanes"))
            assert eng.stats()["gated_iterations"] > 0
            if variant.get("staged_lanes"):
                assert eng.refills > 0


# ---------------------------------------------------------------------------
# device-keyed draws
# ---------------------------------------------------------------------------


def test_draws_depend_on_request_and_index_only():
    """A row's draw is a function of (seed, uid, count) alone: permuting
    the batch permutes the tokens; another seed, uid or count draws
    anew."""
    v = 32
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((6, v))
                              .astype(np.float32))
    uids = torch.tensor([3, 9, 3, 4, 11, 0])
    counts = torch.tensor([0, 5, 1, 7, 2, 2])
    temps, topks = torch.full((6,), 1.0), torch.zeros(6, dtype=torch.int32)
    tok = sample_tokens(logits, temps, topks, draw_keys(5, uids, counts))
    perm = torch.tensor([4, 2, 0, 5, 1, 3])
    tok_p = sample_tokens(logits[perm], temps, topks, draw_keys(5, uids[perm], counts[perm]))
    assert torch.equal(tok_p, tok[perm])
    keys = draw_keys(5, uids, counts)
    assert len(set(keys.tolist())) == 6 and ((keys >= 0) & (keys < 2 ** 32)).all()
    assert not torch.equal(draw_keys(6, uids, counts), keys)
    assert draw_keys(5, uids, counts + 1)[0] != keys[0]


def test_draw_frequencies_follow_the_filtered_softmax():
    """At a fixed seed, 20,000 draws of one row (counts 0..N-1) under
    temperature 0.7 and top-k 5: each token's frequency within 5 standard
    errors of ``softmax(logits / T)`` over the top 5, and no filtered
    token ever drawn."""
    n, v, temp, k = 20000, 12, 0.7, 5
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(v).astype(np.float32))
    keys = draw_keys(0, torch.full((n,), 17), torch.arange(n))
    tok = sample_tokens(logits.expand(n, v), torch.full((n,), temp),
                        torch.full((n,), k, dtype=torch.int32), keys)
    top = torch.topk(logits, k).indices
    p = torch.zeros(v)
    p[top] = torch.softmax(logits[top] / temp, dim=0)
    freq = torch.bincount(tok.long(), minlength=v).float() / n
    se = (p * (1 - p) / n).sqrt()
    assert ((freq - p).abs() <= 5 * se + 1e-9).all(), (freq, p)
    assert freq[p == 0].sum() == 0


def test_greedy_rows_unchanged_beside_sampled_rows():
    """Rows at temperature 0 return the (top-k filtered) argmax whatever
    their batch-mates sample, and equal the all-greedy path."""
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 40))
                              .astype(np.float32))
    temps = torch.tensor([0.0, 1.3, 0.0, 0.5])
    topks = torch.tensor([0, 4, 3, 0], dtype=torch.int32)
    keys = draw_keys(1, torch.arange(4), torch.zeros(4, dtype=torch.int64))
    mixed = sample_tokens(logits, temps, topks, keys)
    greedy = sample_tokens(logits, torch.zeros(4), topks, need_sample=False)
    assert torch.equal(mixed[[0, 2]], greedy[[0, 2]])
    assert torch.equal(greedy, logits.argmax(-1).int())  # top-k keeps the argmax


# ---------------------------------------------------------------------------
# MoE expert counts, the CLI
# ---------------------------------------------------------------------------


def test_expert_counts_replace_bincount_bit_for_bit(monkeypatch):
    """``moe.expert_counts`` gives ``bincount``'s integers, and the reduced
    DeepSeek decode with it gives the same logits, bit for bit, as with
    ``bincount``."""
    fe = torch.from_numpy(np.random.default_rng(3).integers(0, 7, 300))
    assert torch.equal(tmoe.expert_counts(fe, 9), torch.bincount(fe, minlength=9))
    tcfg, tp = port_tree("deepseek-v2-lite-16b")

    def decode():
        cache = tmodel.init_cache(tcfg, 2, 16, device="cpu")
        toks = torch.tensor(prompts(2, tcfg.vocab, lo=6, step=0))
        logits, produced = tmodel.forward(tp, tcfg, toks, want_cache=True)
        tmodel.write_prefill(cache, tcfg, produced, torch.arange(2),
                             torch.full((2,), 6, dtype=torch.int32))
        out = [logits]
        nxt = logits[:, -1].argmax(-1)
        for _ in range(3):
            lg, _ = tmodel.decode_step(tp, tcfg, nxt, cache)
            out.append(lg)
            nxt = lg.argmax(-1)
        return out

    new = decode()
    monkeypatch.setattr(tmoe, "expert_counts",
                        lambda fe, e: torch.bincount(fe, minlength=e))
    old = decode()
    assert all(torch.equal(a, b) for a, b in zip(new, old))


def _cli(*extra):
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--device", "cpu", "--batch", "2", "--requests", "5",
                           "--prompt-len", "8", "--gen", "6", "--paged", "--page-size", "4",
                           "--num-pages", "16", *extra])
    return json.loads(buf.getvalue().strip().splitlines()[-1])["summary"]


def test_cli_device_scheduler_flags():
    """The serve CLI's ``--max-steps-per-dispatch``, ``--staged-lanes`` and
    ``--async-stream`` on the CPU; the summary's counters; the greedy streams
    of the sync CLI run (the CLI serves the bf16 tree; these prompts part
    at no near-tie); the flags without the device scheduler exit with an error."""
    sync = _cli("--steps-per-dispatch", "4")
    dev = _cli("--max-steps-per-dispatch", "4", "--staged-lanes", "2", "--async-stream")
    assert (sync["scheduler"], dev["scheduler"]) == ("sync", "device")
    assert dev["refills"] > 0 and dev["dispatches"] == 2 * dev["cycles"] == 2 * dev["host_syncs"]
    assert (dev["max_steps_per_dispatch"], dev["staged_lanes"], dev["async_stream"]) == (
        4, 2, True)
    assert dev["block_fetches"] == dev["dispatches"]
    assert [len(s) for s in dev["greedy_streams"]] == [6] * 5
    assert dev["greedy_streams"] == sync["greedy_streams"]
    for flag in (["--staged-lanes", "2"], ["--async-stream"]):
        with pytest.raises(SystemExit, match="need the device scheduler"):
            launch_serve.main(["--device", "cpu", *flag])


def test_engine_refuses_bad_device_scheduler_arguments(setup):
    _, tcfg, t = setup
    tp = t["compressed"][1]
    with pytest.raises(ValueError, match="need the device scheduler"):
        DecodeEngine(tcfg, tp, device="cpu", staged_lanes=2)
    with pytest.raises(ValueError, match="max_steps_per_dispatch must be >= 1"):
        DecodeEngine(tcfg, tp, device="cpu", max_steps_per_dispatch=0)
    with pytest.raises(ValueError, match="runs on the card"):
        DecodeEngine(tcfg, tp, device="cpu", max_steps_per_dispatch=4, device_loop="graph")
    # a mesh's model axis
    with pytest.raises(NotImplementedError, match="the rest of tensor parallelism"):
        DecodeEngine(tcfg, tp, device="cpu", max_steps_per_dispatch=4,
                     mesh=SimpleNamespace(model=2, data=1))
    eng = DecodeEngine(tcfg, tp, device="cpu", max_steps_per_dispatch=4, num_pages=8,
                       page_size=4, max_len=16, async_stream=True)
    assert eng.pool.layout.lookahead == 8  # the horizon: 4 steps x 2 dispatches
