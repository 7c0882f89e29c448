"""Self-speculative decoding in the port (``serving.sampling.filtered_probs``
/ ``spec_accept``, ``PagedKVPool.rollback``, ``DecodeEngine(spec_gamma=,
verify_params=)``, the serve CLI's ``--spec-gamma``), held against the JAX
package on the reduced gpt2-paper and DeepSeek-V2-Lite (2 layers) in f32.

- The rule: ``filtered_probs`` within 1e-6 of the reference's; the greedy
  branch of ``spec_accept`` equal to the reference's exactly over random
  cases with per-lane draft lengths (0 included); the sampled branch (the
  port's own draws): the first token's marginal is the verifier's within
  0.01 over 40,000 rows, identical distributions always accept, disjoint
  supports always reject, one-hot rows give the greedy branch.  The draw
  streams of tags 1-3 are independent of plain decode's tag 0.
- The engine: a disagreeing (seed-1) drafter against the seed-0
  masked-dense verifier, on the slab and a 48-page pool of 4-token
  pages, gamma 1 and 3: greedy streams equal the port's plain verifier
  engine's and the reference's spec engine's (except where the top-2
  margin is under ``torch_parity.MARGIN``), and ``spec_rounds``,
  ``draft_tokens`` and ``accepted_draft_tokens`` equal the reference's;
  with chunked prefill and the prefix cache; budget edges and an EOS
  inside an accepted block; DeepSeek (its reduced MoE drops no token);
  after every round each live lane's committed K/V within 1e-4 of a
  verifier forward's; a sampled run.
- The pool: the reference's rollback churn op for op against the
  reference's pool, page tables and refcounts equal after every op.
- The gates (windowed, recurrent, the device scheduler, a model axis > 1,
  no ``verify_params``, gamma out of range), ``pick_spec_gamma`` against
  the reference's, and the CLI's ``--spec-gamma 2`` and ``auto``.
"""
import dataclasses
import io
import json
import random
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import TransformerLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SamplingParams as JaxSampling
from repro.serving.kv_pool import PagedKVPool as JaxPool
from repro.serving.sampling import filtered_probs as jax_filtered_probs
from repro.serving.sampling import spec_accept as jax_spec_accept
from repro.sparse_infer import CompressedTensor as JaxCompressed
from repro_torch.checkpoint import carry_over
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import Mesh
from repro_torch.serving import DecodeEngine, PagedKVPool, SamplingParams
from repro_torch.serving.sampling import _uniforms, draw_keys, filtered_probs, spec_accept
from repro_torch.serving.streams import committed_kv_gaps
from torch_parity import assert_streams_agree, configs, port_tree, to_numpy, trees

# the committed K/V of a lane against a verifier forward's, f32: the routes
# sum in other orders (about 1e-6 at these sizes)
KV_TOL = 1e-4


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
    """Each arch's ``(jcfg, tcfg, {"verify": (jax, port) masked-dense seed 0,
    "draft": (jax, port) a disagreeing compressed drafter, "self": (jax,
    port) compressed seed 0})``, built on first use.  gpt2's drafter is the
    seed-1 export; DeepSeek's (whose JAX export takes 8 s a seed) the
    seed-0 artifact with every kept value negated."""
    built = {}

    def get(arch):
        if arch not in built:
            if arch.startswith("deepseek"):
                jcfg, tcfg, t0 = trees(arch=arch, n_layers=2)
                jdraft = jax.tree_util.tree_map(
                    lambda x: (dataclasses.replace(x, values=-x.values)
                               if isinstance(x, JaxCompressed) else x),
                    t0["compressed"][0], is_leaf=lambda x: isinstance(x, JaxCompressed))
                draft = (jdraft, carry_over(to_numpy(jdraft), device="cpu"))
            else:
                jcfg, tcfg, t0 = trees(arch=arch)
                draft = trees(seed=1, arch=arch)[2]["compressed"]
            built[arch] = (jcfg, tcfg, {"verify": t0["dense"], "draft": draft,
                                        "self": t0["compressed"]})
        return built[arch]

    return get


def _prompts(vocab, lens, seed=100):
    return [np.random.default_rng(seed + i).integers(0, vocab, n).tolist()
            for i, n in enumerate(lens)]


def _stream(eng, prompts, sps):
    uids = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
    res = eng.run()
    return [res[u].tokens for u in uids], [res[u].finish_reason for u in uids]


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("need_topk", [True, False])
def test_filtered_probs_matches_the_reference(need_topk):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 4, 40)).astype(np.float32) * 3
    temps = np.array([0.0, 0.7, 1.0, 1.8, 0.0], np.float32)[:, None].repeat(4, 1)
    topks = np.array([0, 5, 0, 12, 3], np.int32)[:, None].repeat(4, 1)
    want = jax_filtered_probs(jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(topks),
                              need_topk=need_topk)
    got = filtered_probs(torch.from_numpy(logits), torch.from_numpy(temps),
                         torch.from_numpy(topks), need_topk=need_topk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_greedy_accept_matches_the_reference():
    """100 random cases of 6 lanes: drafts that follow the verifier's
    argmax for a random prefix, then random; per-lane ``gi`` in 0..G."""
    rng = np.random.default_rng(1)
    for _ in range(100):
        b, g, v = 6, int(rng.integers(1, 6)), 16
        p_v = rng.random((b, g + 1, v)).astype(np.float32)
        top = p_v.argmax(-1)
        follow = rng.integers(0, g + 1, b)
        drafts = np.where(np.arange(g)[None] < follow[:, None], top[:, :g],
                          rng.integers(0, v, (b, g))).astype(np.int32)
        gi = rng.integers(0, g + 1, b).astype(np.int32)
        keys = jax.random.split(jax.random.PRNGKey(0), b)
        jt, jn = jax_spec_accept(jnp.asarray(drafts), None, jnp.asarray(p_v), jnp.asarray(gi),
                                 keys, keys, need_sample=False)
        tt, tn = spec_accept(torch.from_numpy(drafts), None, torch.from_numpy(p_v),
                             torch.from_numpy(gi), need_sample=False)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _accept_rows(p_d_row, p_v_rows, g, n, seed):
    """``spec_accept`` over ``n`` rows of one ``(p_draft, p_verify)`` pair,
    the drafts drawn from ``p_draft`` per slot (numpy), the accept and
    residual keys the engine's tags 2 and 3 of rows ``0..n-1``."""
    rng = np.random.default_rng(seed)
    v = len(p_d_row)
    drafts = torch.from_numpy(rng.choice(v, size=(n, g), p=p_d_row).astype(np.int32))
    p_d = torch.tensor(p_d_row, dtype=torch.float32).expand(n, g, v)
    p_v = torch.tensor(np.asarray(p_v_rows), dtype=torch.float32).expand(n, g + 1, v)
    uids, counts = torch.arange(n), torch.zeros(n, dtype=torch.int64)
    toks, n_acc = spec_accept(drafts, p_d, p_v, torch.full((n,), g),
                              draw_keys(seed, uids, counts, tag=2),
                              draw_keys(seed, uids, counts, tag=3))
    return toks.numpy(), n_acc.numpy()


def test_rejection_rule_marginal_is_the_verifiers():
    p_d, p_v = [0.7, 0.1, 0.1, 0.1], [0.1, 0.2, 0.3, 0.4]
    n = 40000
    toks, _ = _accept_rows(p_d, [p_v, p_v], 1, n, seed=0)
    np.testing.assert_allclose(np.bincount(toks[:, 0], minlength=4) / n, p_v, atol=0.01)


def test_identical_distributions_always_accept():
    p = [0.25] * 4
    toks, n_acc = _accept_rows(p, [p, p, p], 2, 2000, seed=1)
    assert (n_acc == 2).all()
    assert ((toks >= 0) & (toks < 4)).all()  # the bonus draws from p itself


def test_disjoint_supports_always_reject():
    toks, n_acc = _accept_rows([1.0, 0.0, 0.0, 0.0], [[0.0, 0.5, 0.5, 0.0]] * 2, 1, 500,
                               seed=3)
    assert (n_acc == 0).all()
    assert set(np.unique(toks[:, 0])) <= {1, 2}  # the residual is p_verify itself


def test_onehot_rows_give_the_greedy_branch():
    """Temperature-0 rows: one-hot distributions, and the sampled branch
    accepts the longest argmax-matching prefix, as the greedy branch does,
    over random per-lane draft lengths."""
    b, g, v = 8, 3, 16
    rng = np.random.default_rng(4)
    lv = torch.from_numpy(rng.standard_normal((b, g + 1, v)).astype(np.float32))
    ld = lv[:, :g] + torch.from_numpy(rng.standard_normal((b, g, v)).astype(np.float32))
    p_d = filtered_probs(ld, torch.zeros(b, g), torch.zeros(b, g, dtype=torch.int32))
    p_v = filtered_probs(lv, torch.zeros(b, g + 1), torch.zeros(b, g + 1, dtype=torch.int32))
    drafts = ld.argmax(-1).int()  # what a greedy drafter proposes
    gi = torch.from_numpy(rng.integers(0, g + 1, b))
    keys = draw_keys(5, torch.arange(b), torch.zeros(b, dtype=torch.int64), tag=2)
    tg, ng = spec_accept(drafts, p_d, p_v, gi, need_sample=False)
    ts, ns = spec_accept(drafts, p_d, p_v, gi, keys, keys + 1)
    assert torch.equal(ng, ns) and torch.equal(tg, ts)
    assert (ng.long() <= gi).all()


def test_draw_tags_are_independent_streams():
    """Tag 0 is plain decode's keys, bit for bit; tags 1-3 give other keys
    for every (request, index), and their uniforms are uncorrelated with
    tag 0's and with each other's."""
    n = 4096
    uids, counts = torch.arange(n) % 37, torch.arange(n) // 37
    base = draw_keys(9, uids, counts)
    assert torch.equal(draw_keys(9, uids, counts, tag=0), base)
    u = {tag: _uniforms(draw_keys(9, uids, counts, tag=tag), 8).flatten().double()
         for tag in range(4)}
    for tag in (1, 2, 3):
        assert not (draw_keys(9, uids, counts, tag=tag) == base).any()
        for other in range(tag):
            r = torch.corrcoef(torch.stack([u[tag], u[other]]))[0, 1].item()
            assert abs(r) < 0.03, (tag, other, r)
        assert abs(u[tag].mean().item() - 0.5) < 0.01


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

POOLS = {"slab": {}, "paged": dict(num_pages=48, page_size=4)}


def _check_committed_kv(eng, tcfg, verifier):
    """Every live lane's committed K/V against a verifier forward's."""
    toks = {i: (s.prompt + s.generated)[:s.pos] for i, s in enumerate(eng.slots)
            if s is not None and not s.pending}
    for lane, rec in committed_kv_gaps(tcfg, verifier, eng.cache, eng.layout, toks).items():
        assert rec["max_abs"] <= KV_TOL, (lane, rec)
    return len(toks)


def _rounds(eng, prompts, sps, tcfg=None, verifier=None):
    """``_stream`` step by step, checking the committed K/V after every
    round when ``verifier`` is given; returns the streams, the reasons and
    the lanes checked."""
    uids = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
    res, checked = {}, 0
    while eng.queue or any(s is not None for s in eng.slots):
        for r in eng.step():
            res[r.uid] = r
        if verifier is not None:
            checked += _check_committed_kv(eng, tcfg, verifier)
    return [res[u].tokens for u in uids], [res[u].finish_reason for u in uids], checked


@pytest.mark.parametrize("gamma", [1, 3])
@pytest.mark.parametrize("pool", list(POOLS))
def test_disagreeing_drafter_matches_plain_and_the_reference(setups, pool, gamma):
    jcfg, tcfg, t = setups("gpt2-paper")
    kw = dict(max_batch=3, max_len=32, **POOLS[pool])
    prompts = _prompts(tcfg.vocab, [7, 4, 9])
    sps = [SamplingParams(max_new_tokens=10)] * 3
    base = _stream(DecodeEngine(tcfg, t["verify"][1], device="cpu", **kw), prompts, sps)
    eng = DecodeEngine(tcfg, t["draft"][1], device="cpu", spec_gamma=gamma,
                       verify_params=t["verify"][1], **kw)
    got = _rounds(eng, prompts, sps, tcfg, t["verify"][1])
    jeng = JaxEngine(TransformerLM(jcfg), t["draft"][0], spec_gamma=gamma,
                     verify_params=t["verify"][0], **kw)
    ref = _stream(jeng, prompts, [JaxSampling(max_new_tokens=10)] * 3)
    assert got[0] == base[0] and got[1] == base[1] == ref[1]
    for p, a, b in zip(prompts, got[0], ref[0]):
        assert_streams_agree(tcfg, t["verify"][1], p, a, b)
    st, jst = eng.stats(), jeng.stats()
    keys = ("spec_gamma", "spec_rounds", "draft_tokens", "verify_tokens",
            "accepted_draft_tokens", "spec_emitted_tokens")
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    assert st["host_syncs"] == st["spec_rounds"] > 0
    assert st["acceptance_rate"] < 1.0 and got[2] > 0  # rejected, rolled back, checked
    if eng.pool is not None:
        assert eng.pool.free_pages == eng.pool.layout.num_pages and (eng.pool._ref == 0).all()


@pytest.mark.parametrize("pool", list(POOLS))
def test_self_drafter_accepts_everything(setups, pool):
    """The compressed tree drafting for its own masked-dense tree (the
    CLI's pairing): the same function, so every draft is accepted and a
    round commits gamma + 1 tokens a lane, the streams the plain
    verifier's."""
    _, tcfg, t = setups("gpt2-paper")
    kw = dict(max_batch=2, max_len=32, **POOLS[pool])
    prompts = _prompts(tcfg.vocab, [6, 3])
    sps = [SamplingParams(max_new_tokens=12)] * 2
    base = _stream(DecodeEngine(tcfg, t["verify"][1], device="cpu", **kw), prompts, sps)
    eng = DecodeEngine(tcfg, t["self"][1], device="cpu", spec_gamma=4,
                       verify_params=t["verify"][1], **kw)
    got = _rounds(eng, prompts, sps, tcfg, t["verify"][1])
    assert got[:2] == base
    st = eng.stats()
    assert st["acceptance_rate"] == 1.0 and st["host_syncs"] < st["spec_emitted_tokens"]
    assert st["draft_weight_bytes_per_step"] < st["verify_weight_bytes_per_step"]


def _waves(run, eng, waves, sp):
    """``run(eng, prompts, sps)`` wave by wave, each drained before the
    next is submitted (so that a later wave hits the index); the streams
    and reasons joined."""
    toks, reasons = [], []
    for prompts in waves:
        got = run(eng, prompts, [sp] * len(prompts))
        toks, reasons = toks + got[0], reasons + got[1]
    return toks, reasons


def test_chunked_prefill_and_prefix_cache(setups):
    """Spec on top of chunked admission and a prefix hit (the reference's
    ``test_parity_with_chunked_prefill_and_prefix_cache``, its two prompts
    in two waves so that the second hits the first's 6-token head)."""
    jcfg, tcfg, t = setups("gpt2-paper")
    prompts = _prompts(tcfg.vocab, [9, 9], seed=40)
    prompts[1] = prompts[0][:6] + prompts[1][6:]
    waves, sp = [prompts[:1], prompts[1:]], SamplingParams(max_new_tokens=8)
    kw = dict(max_batch=2, max_len=32, num_pages=48, page_size=4, prefill_chunk=4,
              prefix_cache=True)
    base = _waves(_stream, DecodeEngine(tcfg, t["verify"][1], device="cpu", **kw), waves, sp)
    eng = DecodeEngine(tcfg, t["draft"][1], device="cpu", spec_gamma=3,
                       verify_params=t["verify"][1], **kw)
    got = _waves(lambda e, p, s: _rounds(e, p, s, tcfg, t["verify"][1]), eng, waves, sp)
    jeng = JaxEngine(TransformerLM(jcfg), t["draft"][0], spec_gamma=3,
                     verify_params=t["verify"][0], **kw)
    ref = _waves(_stream, jeng, waves, JaxSampling(max_new_tokens=8))
    assert got == base
    for p, a, b in zip(prompts, got[0], ref[0]):
        assert_streams_agree(tcfg, t["verify"][1], p, a, b)
    st, jst = eng.stats(), jeng.stats()
    keys = ("spec_rounds", "draft_tokens", "accepted_draft_tokens", "prefix_hits",
            "prefill_chunks")
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    assert st["prefix_hits"] == 1 and st["prefill_chunks"] > 0


def test_budget_edges_and_eos_mid_block(setups):
    """A 1-token budget goes straight to the verify pass's token, an EOS
    inside an accepted block drops the rest, as the plain engine stops."""
    jcfg, tcfg, t = setups("gpt2-paper")
    prompts = _prompts(tcfg.vocab, [5, 5, 5])
    probe, _ = _stream(DecodeEngine(tcfg, t["verify"][1], max_batch=3, max_len=32,
                                    device="cpu"), prompts, [SamplingParams(max_new_tokens=8)] * 3)
    # request 1's EOS: a token of its own plain stream, past its 3rd, not
    # emitted before (so it fires inside a round)
    eos = next(x for j, x in enumerate(probe[1]) if j >= 3 and x not in probe[1][:j])
    sps = [SamplingParams(max_new_tokens=1), SamplingParams(max_new_tokens=8, eos_id=eos),
           SamplingParams(max_new_tokens=8)]
    base = _stream(DecodeEngine(tcfg, t["verify"][1], max_batch=3, max_len=32, device="cpu"),
                   prompts, sps)
    eng = DecodeEngine(tcfg, t["self"][1], max_batch=3, max_len=32, device="cpu",
                       spec_gamma=6, verify_params=t["verify"][1])
    got = _rounds(eng, prompts, sps, tcfg, t["verify"][1])
    jeng = JaxEngine(TransformerLM(jcfg), t["self"][0], max_batch=3, max_len=32, spec_gamma=6,
                     verify_params=t["verify"][0])
    ref = _stream(jeng, prompts, [JaxSampling(max_new_tokens=sp.max_new_tokens,
                                              eos_id=sp.eos_id) for sp in sps])
    assert got[:2] == base and got[1] == ref[1] == ["length", "eos", "length"]
    assert [len(x) for x in got[0]] == [len(x) for x in ref[0]]
    # request 0 ends on its prefill token, in no round
    assert eng.stats()["spec_per_request"] == jeng.stats()["spec_per_request"]
    assert 0 not in eng.stats()["spec_per_request"]


def test_deepseek_disagreeing_drafter(setups):
    """Reduced DeepSeek (MLA, MoE of 4 experts whose capacity drops no
    token): the negated drafter on a pool, gamma 3, against the plain
    verifier and the reference; K1b and MLA through the draft scan."""
    jcfg, tcfg, t = setups("deepseek-v2-lite-16b")
    assert tcfg.moe.capacity_factor >= tcfg.moe.n_experts / tcfg.moe.top_k  # no drops
    kw = dict(max_batch=3, max_len=32, num_pages=48, page_size=4)
    prompts = _prompts(tcfg.vocab, [7, 4, 9])
    sps = [SamplingParams(max_new_tokens=8)] * 3
    base = _stream(DecodeEngine(tcfg, t["verify"][1], device="cpu", **kw), prompts, sps)
    eng = DecodeEngine(tcfg, t["draft"][1], device="cpu", spec_gamma=3,
                       verify_params=t["verify"][1], **kw)
    got = _stream(eng, prompts, sps)
    jeng = JaxEngine(TransformerLM(jcfg), t["draft"][0], spec_gamma=3,
                     verify_params=t["verify"][0], **kw)
    ref = _stream(jeng, prompts, [JaxSampling(max_new_tokens=8)] * 3)
    assert got[:2] == base
    for p, a, b in zip(prompts, got[0], ref[0]):
        assert_streams_agree(tcfg, t["verify"][1], p, a, b)
    st, jst = eng.stats(), jeng.stats()
    keys = ("spec_rounds", "draft_tokens", "accepted_draft_tokens")
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}


def test_committed_kv_catches_an_off_by_one_rewind(setups, monkeypatch):
    """The committed-K/V check fails when the rewind keeps one slot too
    many (the last rejected draft's K/V counted as committed): the check
    the 0.1 stream gate is blind to."""
    _, tcfg, t = setups("gpt2-paper")
    eng = DecodeEngine(tcfg, t["draft"][1], device="cpu", max_batch=2, max_len=32,
                       spec_gamma=3, verify_params=t["verify"][1], **POOLS["paged"])
    verify = eng._verify

    def off_by_one(r, drafts, dprobs):
        block, n_acc = verify(r, drafts, dprobs)
        eng.cache["len"].add_(r["active"].int())
        return block, n_acc

    monkeypatch.setattr(eng, "_verify", off_by_one)
    for p in _prompts(tcfg.vocab, [7, 5]):
        eng.submit(p, SamplingParams(max_new_tokens=8))
    eng.step()  # admission and the first round
    eng.step()
    with pytest.raises(AssertionError):
        _check_committed_kv(eng, tcfg, t["verify"][1])


def test_sampled_run(setups):
    """Temperature 0.9, top-k 16, drafter == verifier: every draft is
    accepted (the ratio is 1), every request ends on its budget, and a
    greedy lane in the same batch keeps the plain engine's stream."""
    _, tcfg, t = setups("gpt2-paper")
    prompts = _prompts(tcfg.vocab, [6, 4])
    sps = [SamplingParams(max_new_tokens=10, temperature=0.9, top_k=16),
           SamplingParams(max_new_tokens=10)]
    greedy = _stream(DecodeEngine(tcfg, t["verify"][1], max_batch=2, max_len=32, seed=11,
                                  device="cpu"), prompts, [SamplingParams(max_new_tokens=10)] * 2)
    eng = DecodeEngine(tcfg, t["verify"][1], max_batch=2, max_len=32, seed=11, device="cpu",
                       spec_gamma=3, verify_params=t["verify"][1])
    toks, reasons = _stream(eng, prompts, sps)
    assert eng.stats()["acceptance_rate"] == 1.0
    assert [len(x) for x in toks] == [10, 10] and reasons == ["length", "length"]
    assert all(0 <= x < tcfg.vocab for x in toks[0])
    assert toks[1] == greedy[0][1]


# ---------------------------------------------------------------------------
# the pool's rollback
# ---------------------------------------------------------------------------


def _same_pool(jp, tp):
    assert tp._free == jp._free
    np.testing.assert_array_equal(tp._ref, jp._ref)
    np.testing.assert_array_equal(tp._pt["full"], jp._pt_full)
    assert tp._pages["full"] == jp._full_pages
    assert tp.pending_copies == jp.pending_copies
    assert tp.free_pages + tp.used_pages == tp.layout.num_pages
    assert tp.used_pages == int((tp._ref > 0).sum())


def test_rollback_churn_matches_the_reference():
    """The reference's churn (``tests/test_speculative.py:429``): 400 random
    ops (admissions, some sharing a live lane's prefix; speculative
    reservations of gamma + 1 writes rolled back to a random accepted
    length; releases; copy drains) on both pools, the same state after
    each; nothing left at the end."""
    jcfg, tcfg = configs()
    kw = dict(max_batch=4, max_len=32, num_pages=24, page_size=4)
    jp, tp = JaxPool(TransformerLM(jcfg), **kw), PagedKVPool(tcfg, device="cpu", **kw)
    rng = random.Random(11)
    gamma, lens, rolled = 6, {}, 0
    for _ in range(400):
        op = rng.random()
        idle = [lane for lane in range(tp.max_batch) if lane not in lens]
        live = sorted(lens)
        if op < 0.35 and idle:
            lane, plen = rng.choice(idle), rng.randint(2, 16)
            shared, shared_len = (), 0
            donors = [d for d in live if lens[d] >= 2]
            if donors and rng.random() < 0.5:
                d = rng.choice(donors)
                shared_len = rng.randint(1, min(lens[d], plen) - 1)
                full, tail = tp.prompt_pages(d, shared_len)
                shared = tuple(full + ([tail] if tail is not None else []))
            ok = tp.alloc_prefill(lane, plen, shared_full=shared, shared_len=shared_len)
            assert ok == jp.alloc_prefill(lane, plen, shared_full=shared, shared_len=shared_len)
            if ok:
                lens[lane] = plen
        elif op < 0.80 and live:
            lane = rng.choice(live)
            horizon = min(gamma + 1, tp.max_len - lens[lane])
            ok = horizon >= 1 and tp.ensure_steps(lane, lens[lane], horizon)
            assert ok == (horizon >= 1 and jp.ensure_steps(lane, lens[lane], horizon))
            if not ok:
                tp.release(lane), jp.release(lane)
                del lens[lane]
            else:
                lens[lane] += rng.randint(1, horizon)
                tp.rollback(lane, lens[lane]), jp.rollback(lane, lens[lane])
                rolled += 1
        elif op < 0.9 and live:
            lane = rng.choice(live)
            tp.release(lane), jp.release(lane)
            del lens[lane]
        elif tp.pending_copies:
            tp.apply_pending()
            jp.cache = jp.apply_pending(jp.cache)
        _same_pool(jp, tp)
    for lane in list(lens):
        tp.release(lane), jp.release(lane)
    tp.apply_pending()
    jp.cache = jp.apply_pending(jp.cache)
    _same_pool(jp, tp)
    assert rolled > 100 and tp.free_pages == tp.layout.num_pages and (tp._ref == 0).all()


def test_rollback_keeps_shared_and_next_write_pages():
    """The reference's two rollback cases: a fork rolled back through its
    shared prefix only drops its own claims; the page of the next write
    stays mapped, the pages past it go."""
    _, tcfg = configs()
    tp = PagedKVPool(tcfg, device="cpu", max_batch=2, max_len=32, num_pages=16, page_size=4)
    assert tp.alloc_prefill(0, 12)
    full, _ = tp.prompt_pages(0, 12)
    assert tp.alloc_prefill(1, 13, shared_full=tuple(full), shared_len=12)
    assert tp.ensure_steps(1, 13, 7)
    tp.rollback(1, 14)
    assert all(tp._ref[p] == 2 for p in full) and sorted(tp._pages["full"][1]) == [0, 1, 2, 3]
    tp.release(0), tp.release(1)
    assert tp.free_pages == tp.layout.num_pages
    assert tp.alloc_prefill(0, 4) and tp.ensure_steps(0, 4, 8)
    used = tp.used_pages
    tp.rollback(0, 5)
    assert tp.used_pages == used - 1 and sorted(tp._pages["full"][0]) == [0, 1]
    assert tp._pt["full"][0, 2] == tp.layout.sentinel


# ---------------------------------------------------------------------------
# the gates, gamma's pick, the CLI
# ---------------------------------------------------------------------------


def test_gating_errors(setups):
    _, tcfg, t = setups("gpt2-paper")
    comp, ver = t["draft"][1], t["verify"][1]
    kw = dict(max_batch=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="verify_params"):
        DecodeEngine(tcfg, comp, spec_gamma=2, **kw)
    with pytest.raises(ValueError, match="sync scheduler"):
        DecodeEngine(tcfg, comp, spec_gamma=2, verify_params=ver, max_steps_per_dispatch=4, **kw)
    with pytest.raises(ValueError, match=">= 1"):
        DecodeEngine(tcfg, comp, spec_gamma=0, verify_params=ver, **kw)
    with pytest.raises(ValueError, match="max_len"):
        DecodeEngine(tcfg, comp, spec_gamma=16, verify_params=ver, **kw)
    mesh = Mesh(shape=(1, 2), rank=0, device=torch.device("cpu"), backend="none")
    with pytest.raises(NotImplementedError, match="model axis"):
        DecodeEngine(tcfg, comp, spec_gamma=2, verify_params=ver, mesh=mesh, num_pages=8, **kw)
    rcfg, rp = port_tree("recurrentgemma-9b")
    with pytest.raises(ValueError, match="window"):
        DecodeEngine(rcfg, rp, spec_gamma=2, verify_params=rp, **kw)
    with pytest.raises(ValueError, match="RG-LRU"):  # recurrent layers without a window
        DecodeEngine(dataclasses.replace(rcfg, local_window=None), rp, spec_gamma=2,
                     verify_params=rp, **kw)


def test_pick_spec_gamma_matches_the_reference():
    for d in (0, 1, 10, 50, 100, 200, 500, 800, 1000, 2000, 10**6):
        for v in (1, 100, 1000, 10**4, 10**7):
            assert DecodeEngine.pick_spec_gamma(d, v) == JaxEngine.pick_spec_gamma(d, v)
    assert DecodeEngine.pick_spec_gamma(10, 1000) > DecodeEngine.pick_spec_gamma(1000, 1000)


def _cli(*extra):
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--device", "cpu", "--batch", "2", "--requests", "3",
                           "--prompt-len", "8", "--gen", "8", *extra])
    return json.loads(buf.getvalue().strip().splitlines()[-1])["summary"]


def test_cli_spec_gamma():
    """``--spec-gamma 2`` and ``auto`` on the CPU (the compressed drafter
    against the masked-dense verifier of the same export) and ``--dense
    --spec-gamma 2`` (drafter == verifier): streams of the plain
    ``--dense`` run, acceptance 1 (the drafter is the verifier's function),
    the spec keys; over a model axis > 1, with the device scheduler and
    on a windowed arch it is refused."""
    base = _cli("--dense", "--paged", "--page-size", "4")
    for extra in (("--spec-gamma", "2"), ("--spec-gamma", "auto"),
                  ("--dense", "--spec-gamma", "2")):
        got = _cli("--paged", "--page-size", "4", *extra)
        assert got["greedy_streams"] == base["greedy_streams"], extra
        assert got["spec_gamma"] >= 1 and got["host_syncs"] == got["spec_rounds"]
        assert got["acceptance_rate"] == 1.0 and got["bytes_per_accepted_token"] > 0
    with pytest.raises(NotImplementedError, match="spec-gamma"):
        launch_serve.main(["--device", "cpu", "--paged", "--mesh", "1,2", "--spec-gamma", "2"])
    with pytest.raises(ValueError, match="sync scheduler"):
        _cli("--spec-gamma", "2", "--max-steps-per-dispatch", "4")
    with pytest.raises(ValueError, match="window"):
        _cli("--spec-gamma", "2", "--arch", "recurrentgemma-9b")
