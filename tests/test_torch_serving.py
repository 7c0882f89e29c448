"""The port's sync-scheduler ``DecodeEngine`` held against JAX
``DecodeEngine(mesh=None)`` on the same f32 weights and requests: greedy
streams token-equal wherever the top-2 margin clears ``torch_parity.MARGIN``,
the pool's page accounting equal step for step, and preempt-and-resume on
an undersized pool."""
import pytest

from repro.models.model import TransformerLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SamplingParams as JaxSampling
from repro_torch.serving import DecodeEngine, SamplingParams
from torch_parity import assert_streams_agree, prompts, trees


@pytest.fixture(scope="module")
def setup():
    return trees()


def _run(eng, reqs, sp_cls):
    uids = [eng.submit(p, sp_cls(max_new_tokens=n)) for p, n in reqs]
    res = eng.run()
    return [res[u].tokens for u in uids], [res[u].finish_reason for u in uids]


def _engines(setup, kind, layout, k, **kw):
    jcfg, tcfg, t = setup
    jp, tp = t[kind]
    paged = dict(num_pages=kw.pop("num_pages", 12), page_size=kw.pop("page_size", 4)) \
        if layout == "paged" else {}
    common = dict(max_batch=2, max_len=kw.pop("max_len", 24), seed=0,
                  steps_per_dispatch=k, **paged)
    return (JaxEngine(TransformerLM(jcfg), jp, **common),
            DecodeEngine(tcfg, tp, device="cpu", **common))


@pytest.mark.parametrize("layout,kind,k", [
    ("slab", "dense", 1), ("slab", "compressed", 1), ("paged", "dense", 1),
    ("paged", "compressed", 1), ("paged", "compressed", 4),
])
def test_greedy_streams_match_jax(setup, layout, kind, k):
    """Four ragged requests over two lanes (slot reuse, mixed budgets)."""
    _, tcfg, t = setup
    reqs = list(zip(prompts(4, tcfg.vocab), [6, 4, 7, 5]))
    jeng, teng = _engines(setup, kind, layout, k)
    jt, jr = _run(jeng, reqs, JaxSampling)
    tt, tr = _run(teng, reqs, SamplingParams)
    for (p, _), a, b in zip(reqs, tt, jt):
        assert_streams_agree(tcfg, t[kind][1], p, a, b)
    if tt == jt:
        assert tr == jr
    assert teng.kernel_route() == ("plain" if layout == "paged" else "slab")


def test_pool_accounting_equal_step_for_step(setup):
    """An undersized pool: after every scheduling step the port's free and
    used pages sum to the pool and equal the JAX pool's, through the same
    preemptions."""
    _, tcfg, _ = setup
    reqs = list(zip(prompts(3, tcfg.vocab, lo=5, step=2), [8, 8, 8]))
    jeng, teng = _engines(setup, "compressed", "paged", 1, num_pages=6)
    for p, n in reqs:
        jeng.submit(p, JaxSampling(max_new_tokens=n))
        teng.submit(p, SamplingParams(max_new_tokens=n))
    pool = teng.pool
    while jeng.queue or any(jeng.slots):
        jeng.step()
        teng.step()
        held = sum(len(pool.lane_pages(i)) for i in range(teng.max_batch))
        assert pool.free_pages + pool.used_pages == pool.layout.num_pages
        assert pool.free_pages + held == pool.layout.num_pages  # no leak, no double map
        assert pool.free_pages == jeng.pool.free_pages
        assert teng.preemptions == jeng.preemptions
    assert not teng.queue and not any(teng.slots)
    assert teng.preemptions > 0
    assert pool.free_pages == pool.layout.num_pages


def test_preemption_resumes_to_the_unpreempted_stream(setup):
    """A pool too small for two whole requests preempts the youngest lane
    and resumes it from prompt + generated prefix: the same greedy tokens
    as an unpreempted slab run, every request finishing on its budget."""
    _, tcfg, t = setup
    tp = t["compressed"][1]
    reqs = list(zip(prompts(2, tcfg.vocab, lo=5, step=0), [8, 8]))
    ref = DecodeEngine(tcfg, tp, max_batch=2, max_len=16, device="cpu")
    t_ref, _ = _run(ref, reqs, SamplingParams)
    eng = DecodeEngine(tcfg, tp, max_batch=2, max_len=16, num_pages=8, page_size=2,
                       device="cpu")
    toks, reasons = _run(eng, reqs, SamplingParams)
    assert eng.preemptions > 0
    assert toks == t_ref
    assert reasons == ["length", "length"]


def test_sampled_streams_independent_of_batch_and_dispatch(setup):
    """Draws are keyed by (seed, request uid, token index): request 0
    samples the same tokens alone, beside a second request, and under K=4."""
    _, tcfg, t = setup
    tp = t["compressed"][1]
    p = prompts(2, tcfg.vocab)
    sp = SamplingParams(temperature=1.0, top_k=5, max_new_tokens=6)

    def stream(k, others):
        eng = DecodeEngine(tcfg, tp, max_batch=2, max_len=24, steps_per_dispatch=k,
                           device="cpu")
        uid = eng.submit(p[0], sp)
        for q in others:
            eng.submit(q, SamplingParams(max_new_tokens=4))
        return eng.run()[uid].tokens

    alone = stream(1, [])
    assert len(alone) == 6
    assert stream(1, [p[1]]) == alone
    assert stream(4, [p[1]]) == alone
