"""Chunked prefill in the port (``models.model.prefill_chunk``, the layouts'
``write_chunk``/``chunk_view``/``chunk_view_win``, ``DecodeEngine(
prefill_chunk=)``), held against the JAX package on the reduced gpt2-paper
and DeepSeek-V2-Lite (2 layers: its dense first and one MoE layer) in f32.

- ``chunked_attention``: with its defaults, the same bits as its version
  before per-row offsets (kept here); with per-row ``q_offset`` and
  ``kv_valid_from``, the reference's within 1e-5.
- The layouts' chunk writes and views on the same numpy rows and tables:
  the slab, fp and int8 pools and the window table, equal to the
  reference's exactly (codes and scales too) wherever a real query can
  read.
- ``prefill_chunk`` chunk by chunk (three lanes of 13, 6 and 10 tokens in
  chunks of 4, rows padded with a sentinel lane) against the reference's
  on the slab, fp pages and int8 pages, and a windowed gpt2
  (``local_window=8``) on pages, ``all_logits`` on and off: logits within
  ``LOGIT_TOL`` (1e-4; 5e-3 on int8 pools), the written rows exactly the
  reference's slots with fp values within ``LOGIT_TOL``, int8 codes
  within one step (at most ``INT8_CODE_SHARE`` of the written codes off)
  and f16 scales within one f16 step (f32 K/V of the two
  frameworks differ by about 1e-6, which can move a code or a scale
  across a rounding edge), ``len`` exact; each lane's last chunk gives the
  monolithic forward's last logits within ``LOGIT_TOL`` on fp layouts.
- The engine's streams against the reference engine's with the same
  ``prefill_chunk``: slab and pools, int8, the windowed gpt2,
  and the device scheduler's chunk drain; streams equal except where the
  top-2 margin is under ``torch_parity.MARGIN`` (1e-2 on int8 pages,
  whose codes the two packages may round one step apart); the chunk and scheduling
  counters equal.  ``max_prefill_batch``'s cap on a step's admissions,
  as the reference's.  The gates (recurrent archs, a windowed arch on
  the slab) and the CLI's ``--prefill-chunk``.  DeepSeek's engine chunks a
  prefix hit's tail in ``tests/test_torch_prefix_cache.py``.
"""
import dataclasses
import io
import json
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cache as jcache
from repro.models import layers as jlayers
from repro.models.model import TransformerLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SamplingParams as JaxSampling
from repro.serving.kv_pool import PagedKVPool as JaxPool
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.cache import PagedLayout, SlabLayout
from repro_torch.serving import DecodeEngine, SamplingParams
from repro_torch.serving.kv_pool import PagedKVPool
from torch_parity import LOGIT_TOL, MARGIN, assert_streams_agree, configs, port_tree, trees

ARCHS = {"gpt2": "gpt2-paper", "deepseek": "deepseek-v2-lite-16b"}
# the model-level schedule: three lanes' prompt lengths, chunks of 4, pages of 4
LENS, CSZ, PS, MAX_LEN = (13, 6, 10), 4, 4, 32


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
    """Each arch's ``trees`` (JAX and port, compressed), built on first use;
    ``"gpt2-window"`` is gpt2's tree under ``local_window=8``."""
    built = {}

    def get(name):
        arch = ARCHS[name.split("-")[0]]
        if arch not in built:  # DeepSeek: its dense first layer and one MoE layer
            jcfg, tcfg, t = trees(arch=arch, **({"n_layers": 2} if name == "deepseek" else {}))
            built[arch] = (jcfg, tcfg, t["compressed"])
        jcfg, tcfg, tree = built[arch]
        if name.endswith("-window"):
            jcfg = dataclasses.replace(jcfg, local_window=8)
            tcfg = dataclasses.replace(tcfg, local_window=8)
        return jcfg, tcfg, tree

    return get


# ---------------------------------------------------------------------------
# chunked_attention
# ---------------------------------------------------------------------------


def _attention_before(q, k, v, *, window=None, chunk=512):
    """``layers.chunked_attention`` as it was before per-row offsets."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    q_pos = torch.arange(sq)
    m = torch.full((b, hkv, g, sq), -1e30)
    l = torch.zeros((b, hkv, g, sq))
    acc = torch.zeros((b, hkv, g, sq, d))
    for c0 in range(0, sk, chunk):
        kb, vb = k[:, c0:c0 + chunk].float(), v[:, c0:c0 + chunk].float()
        kv_pos = c0 + torch.arange(kb.shape[1])
        mask = kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb) * d ** -0.5
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * mask
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1)
        acc = corr[..., None] * acc + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def _qkv(rng, b, sq, sk, dtype=np.float32):
    return (rng.standard_normal((b, sq, 4, 8)).astype(dtype),
            rng.standard_normal((b, sk, 2, 8)).astype(dtype),
            rng.standard_normal((b, sk, 2, 8)).astype(dtype))


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_attention_defaults_keep_their_bits(window, dtype):
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(np.random.default_rng(0), 2, 11, 11))
    got = tlayers.chunked_attention(q, k, v, window=window, chunk=4)
    assert torch.equal(got, _attention_before(q, k, v, window=window, chunk=4))


def test_chunked_attention_per_row_offsets_match_the_reference():
    """Rows at their own positions over a longer view, with and without a
    window and masked leading slots, against the reference's scan."""
    q, k, v = _qkv(np.random.default_rng(1), 3, 4, 14)
    off, vf = np.array([0, 5, 10]), np.array([0, 2, 7])
    for kw in (dict(q_offset=off), dict(q_offset=off, window=6, kv_valid_from=vf),
               dict(q_offset=3, kv_valid_from=1)):
        want = np.asarray(jlayers.chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=4,
            **{n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}))
        got = tlayers.chunked_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), chunk=4,
            **{n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
               for n, x in kw.items()})
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the layouts' chunk writes and views
# ---------------------------------------------------------------------------


def _chunk_rows(rng, n_rows, csz, shapes):
    return {name: rng.standard_normal((n_rows, csz) + shp).astype(np.float32)
            for name, shp in shapes.items()}


@pytest.mark.parametrize("kind", ["slab", "fp", "int8", "window", "mla_int8"])
def test_chunk_writes_and_views_equal_the_reference(kind):
    """Two chunks of three real rows and a pad row (lane 3 of 3 lanes), the
    same numpy K/V (or MLA latents) into both layouts: the cache equal to
    the reference's exactly (the pool without its sink page), and each
    view equal at every slot a real row's query can read (the reference
    gathers clipped garbage where the port reads its sink page)."""
    rng = np.random.default_rng(2)
    b, p, ps, max_len, csz = 3, 16, 4, 16, 4
    mla = kind.startswith("mla")
    shapes = {"ckv": (12,), "krope": (4,)} if mla else {"k": (2, 8), "v": (2, 8)}
    quant, windowed = kind.endswith("int8"), kind == "window"
    win = 6 if windowed else None
    if kind == "slab":
        jl, tl = jcache.SlabLayout(max_len), SlabLayout(max_len)
        tc = {n: torch.zeros((b, max_len) + s) for n, s in shapes.items()}
        jt = tt = None
    else:
        kw = dict(page_size=ps, num_pages=p, max_len=max_len, quant=quant)
        if windowed:
            kw.update(win=win, has_full=False, lookahead=csz)
        jl, tl = jcache.PagedLayout(**kw), PagedLayout(**kw)
        tc = tl.alloc((), b, shapes, torch.float32, "cpu")
        # lane r's pages r·5.. (distinct), the window table modular
        key = "win" if windowed else "full"
        width = tl.pages_win if windowed else tl.pages_full
        table = np.full((b, width), p, np.int32)
        for r in range(b):
            for pg in range(3 if windowed else width):
                table[r, (pg + 1) % width if windowed else pg] = r * 5 + pg
        jt, tt = {key: jnp.asarray(table)}, {key: torch.from_numpy(table)}
    jc = {n: jnp.asarray(x.numpy() if kind == "slab" else x[:p].numpy())
          for n, x in tc.items()}  # the reference's pool has no sink page
    lanes = np.array([0, 1, 2, b])
    for starts, lengths in ((np.array([0, 4, 1, 0]), np.array([4, 3, 4, 4])),
                            (np.array([4, 7, 5, 0]), np.array([2, 4, 4, 0]))):
        if windowed:
            starts = starts + 2
        rows = _chunk_rows(rng, 4, csz, shapes)
        args = [jnp.asarray(lanes), jnp.asarray(starts), jnp.asarray(lengths), jt]
        names = list(shapes)
        if mla:
            jc = jl.mla_write_chunk(jc, *(jnp.asarray(rows[n]) for n in names), *args)
        else:
            jc = jl.attn_write_chunk(jc, *(jnp.asarray(rows[n]) for n in names), *args,
                                     window=win)
        targs = (torch.from_numpy(lanes), torch.from_numpy(starts),
                 torch.from_numpy(lengths), tt)
        tl.write_chunk(tc, {n: torch.from_numpy(x) for n, x in rows.items()}, *targs,
                       window=win)
        for name, x in tc.items():
            got = x.numpy() if kind == "slab" else x[:p].numpy()
            np.testing.assert_array_equal(got, np.asarray(jc[name]), err_msg=name)
        if windowed:
            jv = jl.attn_chunk_view_win(jc, args[0], args[1], csz, win, jt)
            tv = tl.chunk_view_win(tc, targs[0], targs[1], csz, win, tt)
            a = (starts - win + 1)[:, None] + np.arange(win + csz - 1)
            slot = (np.maximum(a, 0) // ps) % tl.pages_win
            seen = (a >= 0) & (table[np.minimum(lanes, b - 1)[:, None], slot] < p)
        else:
            jv = (jl.mla_chunk_view if mla else jl.attn_chunk_view)(jc, args[0], jt)
            tv = tl.chunk_view(tc, targs[0], tt)
            s = max_len if kind == "slab" else tl.pages_full * ps
            seen = np.ones((4, s), bool)
            if kind != "slab":
                seen = table[np.minimum(lanes, b - 1)][:, np.arange(s) // ps] < p
        seen[lanes >= b] = False
        for name, jx in zip(names, jv):
            np.testing.assert_array_equal(tv[name].numpy()[seen], np.asarray(jx)[seen],
                                          err_msg=name)


# ---------------------------------------------------------------------------
# prefill_chunk, chunk by chunk
# ---------------------------------------------------------------------------


def _pools(jcfg, tcfg, layout):
    """The two caches and layouts for ``layout`` (slab / fp / int8), the
    pools' pages mapped for every lane's prompt (the window table's
    deferred, as the engine defers them)."""
    if layout == "slab":
        return (None, None, jcache.SlabLayout(MAX_LEN), SlabLayout(MAX_LEN),
                TransformerLM(jcfg).init_cache(len(LENS), MAX_LEN),
                tmodel.init_cache(tcfg, len(LENS), MAX_LEN, device="cpu"))
    kw = dict(max_batch=len(LENS), max_len=MAX_LEN, num_pages=24, page_size=PS,
              lookahead=CSZ, quant=layout == "int8")
    jp, tp = JaxPool(TransformerLM(jcfg), **kw), PagedKVPool(tcfg, device="cpu", **kw)
    for lane, n in enumerate(LENS):
        for pool in (jp, tp):
            assert pool.alloc_prefill(lane, n, defer_win=jcfg.local_window is not None)
    return jp, tp, jp.layout, tp.layout, jp.cache, tp.cache


def _leaf_pairs(jc, tc, path=""):
    for name, t in tc.items():
        if name in ("len", "tables"):
            continue
        if isinstance(t, dict):
            yield from _leaf_pairs(jc[name], t, f"{path}/{name}")
        else:
            yield f"{path}/{name}", np.asarray(jc[name]), t.numpy()


CASES = [("gpt2", "slab"), ("gpt2", "fp"), ("gpt2", "int8"), ("deepseek", "slab"),
         ("deepseek", "fp"), ("deepseek", "int8"), ("gpt2-window", "fp")]
# int8 pools: f32 K/V about 1e-6 apart can round to codes (or f16 scales)
# one step apart, which moves a logit by up to about 1e-3
INT8_LOGIT_TOL = dict(atol=5e-3, rtol=5e-3)
# the share of written int8 codes that may sit one step from the reference's
INT8_CODE_SHARE = 1e-3


@pytest.mark.parametrize("arch,layout", CASES, ids=[f"{a}-{l}" for a, l in CASES])
def test_prefill_chunk_matches_the_reference(setups, arch, layout):
    """Every round runs each lane's next chunk (rows padded to 4 with the
    sentinel lane) through both packages twice, for the last logits and
    then with ``all_logits`` (the same rows written again, unchanged)."""
    jcfg, tcfg, (jparams, tparams) = setups(arch)
    jmodel = TransformerLM(jcfg)
    jp, tp, jl, tl, jc, tc = _pools(jcfg, tcfg, layout)
    jchunk = jax.jit(jmodel.prefill_chunk, static_argnames=("layout", "all_logits"))
    tol = INT8_LOGIT_TOL if layout == "int8" else LOGIT_TOL
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, n) for n in LENS]
    pos, last = [0] * len(LENS), {}
    windowed = jcfg.local_window is not None
    while any(p < n for p, n in zip(pos, LENS)):
        rows = [i for i, n in enumerate(LENS) if pos[i] < n]
        if windowed:  # each chunk's window pages, as the engine maps them
            for i in rows:
                for pool in (jp, tp):
                    assert pool.ensure_steps(i, pos[i], min(CSZ, LENS[i] - pos[i]))
        toks = np.zeros((4, CSZ), np.int32)
        lanes = np.full((4,), len(LENS), np.int32)
        starts, lengths = np.zeros((4,), np.int32), np.zeros((4,), np.int32)
        for r, i in enumerate(rows):
            part = prompts[i][pos[i]:pos[i] + CSZ]
            toks[r, :len(part)], lanes[r], starts[r], lengths[r] = part, i, pos[i], len(part)
        if jp is not None:
            jc["tables"] = jp.device_tables()
            tp.device_tables()
        for all_logits in (False, True):
            jlog, jc = jchunk(jparams, jnp.asarray(toks), jc, jnp.asarray(lanes),
                              jnp.asarray(starts), jnp.asarray(lengths), layout=jl,
                              all_logits=all_logits)
            tlog, _ = tmodel.prefill_chunk(tparams, tcfg, torch.from_numpy(toks), tc,
                                           torch.from_numpy(lanes), torch.from_numpy(starts),
                                           torch.from_numpy(lengths), tl,
                                           all_logits=all_logits)
            jlog, tlog = np.asarray(jlog), tlog.numpy()
            for r, i in enumerate(rows):
                n = lengths[r]
                if all_logits:
                    np.testing.assert_allclose(tlog[r, :n], jlog[r, :n], **tol)
                    np.testing.assert_allclose(tlog[r, n - 1], last[i], atol=1e-6, rtol=1e-6)
                else:
                    np.testing.assert_allclose(tlog[r], jlog[r], **tol)
                    last[i] = tlog[r]
        for r, i in enumerate(rows):
            pos[i] += lengths[r]
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert tc["len"].tolist() == list(LENS)
    n_pages = None if layout == "slab" else tl.num_pages
    leaves = {}
    for path, jx, tx in _leaf_pairs(jc, tc):
        if n_pages is not None:  # the port's pool ends with its sink page
            tx = tx[:, :n_pages] if path.startswith("/body") else tx[:n_pages]
        leaves[path] = jx, tx
    for path, (jx, tx) in leaves.items():
        if tx.dtype == np.int8:
            assert np.abs(tx.astype(int) - jx.astype(int)).max() <= 1, path
            # a code moves only where its f32 input sits on a rounding edge:
            # a systematic shift would move far more of the written codes
            off = (tx != jx)[leaves[path + "_scale"][0] > 0]
            assert off.mean() <= INT8_CODE_SHARE, (path, off.mean())
        elif path.endswith("_scale"):  # within one f16 step, on the same slots
            np.testing.assert_allclose(tx, jx, rtol=2e-3, err_msg=path)
            np.testing.assert_array_equal(tx > 0, jx > 0, err_msg=path)
        else:
            np.testing.assert_allclose(tx, jx, err_msg=path, **LOGIT_TOL)
            axes = tuple(range(tx.ndim - (2 if path.endswith(("/k", "/v")) else 1), tx.ndim))
            np.testing.assert_array_equal((tx != 0).any(axes), (jx != 0).any(axes),
                                          err_msg=path)
    if layout != "int8":  # the last chunk's logits are the monolithic prefill's
        for i, n in enumerate(LENS):
            logits, _ = tmodel.forward(tparams, tcfg, torch.from_numpy(prompts[i][None]))
            np.testing.assert_allclose(last[i], logits[0, -1].numpy(), **LOGIT_TOL)


def test_prefill_chunk_refuses_recurrent_mixers():
    tcfg = configs("recurrentgemma-9b")[1]
    params = tmodel.init_params(tcfg, seed=0, device="cpu")
    cache = tmodel.init_cache(tcfg, 1, 16, device="cpu")
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="attention-family"):
        tmodel.prefill_chunk(params, tcfg, torch.zeros((1, 4), dtype=torch.int64), cache,
                             torch.zeros(1, dtype=torch.int32), 0 * one, 4 * one)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _streams(eng, prompts, budgets, sampling=SamplingParams):
    uids = [eng.submit(p, sampling(max_new_tokens=n)) for p, n in zip(prompts, budgets)]
    res = eng.run()
    return [res[u].tokens for u in uids], [res[u].finish_reason for u in uids]


def _engines(setups, arch, **kw):
    """``(tcfg, tparams, port engine, reference engine)`` on the same f32
    weights and arguments."""
    jcfg, tcfg, (jparams, tparams) = setups(arch)
    kw = {"max_batch": 2, "max_len": 40, "seed": 3, **kw}
    return (tcfg, tparams, DecodeEngine(tcfg, tparams, device="cpu", **kw),
            JaxEngine(TransformerLM(jcfg), jparams, **kw))


ENGINE_CASES = {
    "gpt2-slab": ("gpt2", dict(prefill_chunk=8)),
    "gpt2-pool-k4": ("gpt2", dict(prefill_chunk=8, num_pages=24, page_size=4,
                                  steps_per_dispatch=4)),
    "gpt2-int8": ("gpt2", dict(prefill_chunk=8, num_pages=24, page_size=4, kv_quant=True)),
    "gpt2-window-pool": ("gpt2-window", dict(prefill_chunk=4, num_pages=64, page_size=4)),
    "gpt2-device-drain": ("gpt2", dict(prefill_chunk=8, num_pages=32, page_size=4,
                                       max_steps_per_dispatch=5, staged_lanes=1,
                                       async_stream=True)),
    "gpt2-pool-admit-one": ("gpt2", dict(prefill_chunk=8, num_pages=24, page_size=4,
                                         max_prefill_batch=1)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_chunked_streams_match_the_reference(setups, case):
    """Four prompts over two lanes: two longer than a chunk (the first with
    a last chunk of 1 token), one of exactly a chunk and one shorter, both
    prefilled whole.  The port's streams, chunk dispatches and scheduling
    counters equal the reference engine's; on fp layouts its chunked
    streams equal its own monolithic ones except at f32 near-ties."""
    arch, kw = ENGINE_CASES[case]
    tcfg, tparams, teng, jeng = _engines(setups, arch, **kw)
    csz = kw["prefill_chunk"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab, n).tolist()
               for n in (2 * csz + 1, 3, csz, 2 * csz + 3)]
    budgets = (5, 7, 4, 6)
    got = _streams(teng, prompts, budgets)
    want = _streams(jeng, prompts, budgets, JaxSampling)
    # a chunk on int8 pages reads the earlier chunks' codes, which the two
    # packages may round one step apart (about 1e-3 of a logit)
    margin = 1e-2 if kw.get("kv_quant") else MARGIN
    for p, a, b in zip(prompts, got[0], want[0]):
        assert_streams_agree(tcfg, tparams, p, a, b, margin=margin)
    assert got[1] == want[1] == ["length"] * 4
    keys = ("prefill_chunks", "prefill_batches", "decode_steps", "dispatches", "admitted",
            "preemptions", "refills", "cycles")
    tst, jst = teng.stats(), jeng.stats()
    assert {k: tst[k] for k in keys} == {k: jst[k] for k in keys}
    assert teng.prefill_chunk == csz and tst["prefill_chunks"] > 0
    if not kw.get("kv_quant"):  # a monolithic prefill reads fp K/V, a later chunk codes
        mono = {k: v for k, v in kw.items() if k != "prefill_chunk"}
        base = _streams(DecodeEngine(tcfg, tparams, device="cpu", max_batch=2, max_len=40,
                                     seed=3, **mono), prompts, budgets)
        for p, a, b in zip(prompts, got[0], base[0]):
            assert_streams_agree(tcfg, tparams, p, a, b)
    if teng.pool is not None:
        assert teng.pool.free_pages == teng.pool.layout.num_pages


def test_max_prefill_batch_caps_each_steps_admissions(setups):
    """With ``max_prefill_batch=1`` a step admits one queued request even
    with two lanes free, as the reference's does; without it, both."""
    for cap, admitted in ((1, [1, 2]), (None, [2, 2])):
        tcfg, _, teng, jeng = _engines(setups, "gpt2", num_pages=24, page_size=4,
                                       max_prefill_batch=cap)
        rng = np.random.default_rng(6)
        prompts = [rng.integers(0, tcfg.vocab, n).tolist() for n in (5, 6)]
        for eng, sp in ((teng, SamplingParams), (jeng, JaxSampling)):
            for p in prompts:
                eng.submit(p, sp(max_new_tokens=4))
        got = []
        for _ in admitted:
            teng.step()
            jeng.step()
            got.append(teng.stats()["admitted"])
            assert got[-1] == jeng.stats()["admitted"]
        assert got == admitted


def test_chunking_gated_off_recurrent_and_windowed_slab(setups):
    """A recurrent arch keeps its monolithic prefill (on the slab and on
    pages), a windowed arch on the slab too; a windowed pool chunks with a
    window table wide enough for a chunk."""
    tcfg, tp = port_tree("recurrentgemma-9b")
    for kw in ({}, dict(num_pages=16, page_size=4)):
        assert DecodeEngine(tcfg, tp, max_len=40, prefill_chunk=4, device="cpu",
                            **kw).prefill_chunk is None
    _, wcfg, (_, wp) = setups("gpt2-window")
    assert DecodeEngine(wcfg, wp, max_len=32, prefill_chunk=4, device="cpu").prefill_chunk is None
    eng = DecodeEngine(wcfg, wp, max_len=32, prefill_chunk=12, num_pages=32, page_size=4,
                       device="cpu")
    assert eng.prefill_chunk == 12 and eng.pool.layout.lookahead == 12
    with pytest.raises(NotImplementedError, match="the rest of tensor parallelism"):
        DecodeEngine(wcfg, wp, device="cpu", prefill_chunk=4, num_pages=8,
                     mesh=SimpleNamespace(model=2, data=1))


def _cli(*extra):
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--device", "cpu", "--batch", "2", "--requests", "3",
                           "--prompt-len", "12", "--gen", "4", *extra])
    return json.loads(buf.getvalue().strip().splitlines()[-1])["summary"]


def test_cli_prefill_chunk():
    """``--prefill-chunk`` on the CPU: the summary counts the chunk
    dispatches; the greedy streams equal the unchunked run's (the CLI
    serves the bf16 tree; these prompts part at no near-tie)."""
    base = _cli("--paged", "--page-size", "4")
    got = _cli("--paged", "--page-size", "4", "--prefill-chunk", "5")
    # 12 = 5 + 5 + 2: requests 0 and 1 chunk side by side, then request 2
    assert base["prefill_chunks"] == 0 and got["prefill_chunks"] == 6
    assert got["greedy_streams"] == base["greedy_streams"]
    with pytest.raises(NotImplementedError, match="the rest of tensor parallelism"):
        launch_serve.main(["--device", "cpu", "--paged", "--mesh", "1,2",
                           "--prefill-chunk", "4"])
