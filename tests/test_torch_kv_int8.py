"""Int8 KV pages (``--kv-int8``) in the port, held against the JAX package:
the per-token quantization bit for bit; K2q's plain version (``paged_attn``
with scale planes, which CPU tensors take) against the Pallas kernel in
interpret mode on the same int8 operands, in its GQA, window and MLA forms;
the int8 pools of reduced gpt2-paper, DeepSeek-V2-Lite and RecurrentGemma-9B
against ``DecodeEngine(kv_quant=True)`` after prefill and decode steps
(codes and scales on live rows, then greedy streams); the reference's
finish-profile check of int8 against fp streams; and the refusals of the
engine and the CLI.  Tolerances are stated by each test."""
import io
import json
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn import paged_attn_pallas
from repro.launch import serve as jax_serve
from repro.models.cache import PagedLayout as JaxLayout
from repro.models.model import TransformerLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SamplingParams as JaxSampling
from repro_torch.kernels.paged_attn import paged_attn
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as tmodel
from repro_torch.models.cache import dequant, quant
from repro_torch.serving import DecodeEngine, SamplingParams
from repro_torch.utils.tree import tree_items
from torch_parity import assert_streams_agree, full_tables, prompts, trees, win_tables

# f32 on both sides: page-by-page online softmax vs one gathered softmax
TOL = dict(atol=1e-5, rtol=1e-5)
# each arch's reduced trees and serving shape: RecurrentGemma with 8 layers
# (a tail) and max_len 40 past its window of 16, as tests/test_torch_recurrentgemma.py
ARCHS = {
    "gpt2-paper": (dict(), dict(max_len=24, num_pages=12)),
    "deepseek-v2-lite-16b": (dict(), dict(max_len=24, num_pages=12)),
    "recurrentgemma-9b": (dict(n_layers=8), dict(max_len=40, num_pages=24)),
}


@pytest.fixture(scope="module")
def setups():
    """Each arch's ``trees`` (JAX and port), built once on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = trees(arch=arch, **ARCHS[arch][0])
        return cache[arch]

    return get


def _jax_quant(x: np.ndarray, lead: int, dtype):
    jx = jnp.asarray(x).astype(dtype)
    q, s = JaxLayout(page_size=4, num_pages=8, max_len=32, quant=True)._quant(jx, lead)
    return np.asarray(q), np.asarray(s), np.asarray(JaxLayout.dequant(q, s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [1, 2])
def test_quant_is_bit_equal_to_the_reference(dtype, lead):
    """Codes and f16 scales bit-equal to ``PagedLayout._quant``, dequant
    equal, on tokens of ``(Hkv 2, D 16)``: random ones of several
    magnitudes, an all-zero token (the ``_QEPS`` floor), tokens whose codes
    land on exact halves (half to even), and one whose heads differ by 100x
    (one scale per token across heads)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 2, 16)).astype(np.float32) * np.logspace(-3, 2, 12)[:, None, None]
    x[0] = 0.0
    for i, s in ((1, 0.5), (2, 0.375)):  # absmax 127·s with s exact in f16: x/s = k + 0.5
        half = (np.arange(32, dtype=np.float32) * 7 % 253 - 126.5).reshape(2, 16)
        x[i] = half * s
        x[i, 0, 0] = 127 * s
    x[3, 1] *= 0.01
    x = x.reshape((3, 4, 2, 16) if lead == 2 else (12, 2, 16))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js, jd = _jax_quant(tx.float().numpy(), lead, getattr(jnp, dtype))
    q, s = quant(tx, lead)
    assert q.dtype == torch.int8 and s.dtype == torch.float16 and s.shape == x.shape[:lead]
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.view(torch.int16).numpy(), js.view(np.int16))
    np.testing.assert_array_equal(dequant(q, s).numpy(), jd)
    flat_q = q.reshape(12, 2, 16)
    assert bool((flat_q[0] == 0).all()) and float(s.reshape(12)[0]) > 0
    assert bool((flat_q[1].abs() <= 127).all()) and bool((flat_q[1].abs() % 2 == 0).any())
    assert int(flat_q[3, 1].abs().max()) <= 2 < int(flat_q[3, 0].abs().max())


def _quantized(rng, shape):
    """Random pages as the port's int8 codes and f16 scales (numpy)."""
    q, s = quant(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)), 2)
    return q.numpy(), s.numpy()


def _both(q, pages, tables, lens, **kw):
    """The port's plain version and the Pallas kernel (interpret) on the same
    numpy operands: ``pages`` is ``(k_pages, v_pages or None)``, ``kw`` the
    keywords (scale planes among them)."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    y_ref = paged_attn_pallas(jnp.asarray(q), *(jnp.asarray(p) if p is not None else None
                                                for p in pages), jnp.asarray(tables),
                              jnp.asarray(lens), interpret=True, **jkw)
    y = paged_attn(torch.from_numpy(q), *(torch.from_numpy(p) if p is not None else None
                                          for p in pages), torch.from_numpy(tables),
                   torch.from_numpy(lens), **tkw)
    return y, np.asarray(y_ref)


@pytest.mark.parametrize("form", ["gqa", "window", "mla"])
def test_k2q_plain_matches_pallas_interpret(form):
    """K2q on identical int8 operands, to 1e-5: the GQA form (ragged lanes,
    an idle lane), the window form over a modular table (lanes past the
    window, a stale id in an expired slot, an unmapped slot in a live range)
    and the MLA form (f32 queries and output, V the dequantized latent)."""
    rng = np.random.default_rng(11)
    b, ps = 4, 4
    if form == "gqa":
        hkv, g, d, num_pages = 2, 3, 16, 12
        lens = np.asarray([1, 7, 21, 0], np.int32)
        tables = full_tables(lens, ps, 6, num_pages)
        kq, ks = _quantized(rng, (num_pages, ps, hkv, d))
        vq, vs = _quantized(rng, (num_pages, ps, hkv, d))
        q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
        y, y_ref = _both(q, (kq, vq), tables, lens, scale=d ** -0.5, k_scale=ks, v_scale=vs)
        dead = 3
    elif form == "window":
        g, d, win = 4, 16, 10
        win_slots = -(-(win + 4 - 1) // ps) + 1
        lens = np.asarray([21, 17, 0, 30], np.int32)
        num_pages = 4 * win_slots + 1
        tables = win_tables(lens, ps, win, win_slots, num_pages)
        tables[0, 1] = num_pages - 1  # page 1 expired: a stale id
        tables[1, 2] = num_pages  # lane 1's page 2 unmapped
        kq, ks = _quantized(rng, (num_pages, ps, 1, d))
        vq, vs = _quantized(rng, (num_pages, ps, 1, d))
        q = rng.standard_normal((b, 1, g, d)).astype(np.float32)
        y, y_ref = _both(q, (kq, vq), tables, lens, scale=d ** -0.5, window=win,
                         win_slots=win_slots, k_scale=ks, v_scale=vs)
        dead = 2
    else:
        h, latent, rd, num_pages = 4, 16, 8, 12
        lens = np.asarray([5, 19, 0, 12], np.int32)
        tables = full_tables(lens, ps, 5, num_pages)
        tables[1, 2] = num_pages  # an unmapped slot inside lane 1's live range
        cq, cs = _quantized(rng, (num_pages, ps, 1, latent))
        rq, rs = _quantized(rng, (num_pages, ps, 1, rd))
        q = rng.standard_normal((b, 1, h, latent)).astype(np.float32)
        q2 = rng.standard_normal((b, 1, h, rd)).astype(np.float32)
        y, y_ref = _both(q, (cq, None), tables, lens, scale=0.17, q2=q2, k2_pages=rq,
                         v_is_k=True, k_scale=cs, k2_scale=rs)
        assert y.dtype == torch.float32
        dead = 2
    np.testing.assert_allclose(y.numpy(), y_ref, **TOL)
    assert float(y[dead].abs().max()) == 0.0  # idle lane: exact zeros


def _engines(setups, arch, quant_on=True, k=1):
    jcfg, tcfg, t = setups(arch)
    jp, tp = t["compressed"]
    kw = dict(max_batch=2, seed=0, page_size=4, steps_per_dispatch=k, **ARCHS[arch][1])
    return (JaxEngine(TransformerLM(jcfg), jp, kv_quant=quant_on, **kw),
            DecodeEngine(tcfg, tp, device="cpu", kv_quant=quant_on, **kw))


def _live_rows(pool, lane_len: dict, name: str, x: torch.Tensor) -> list:
    """``x`` (a pool leaf or scale plane of layer path ``name``, stacked
    under ``body/``) at each busy lane's live (page, slot) rows, through the
    port pool's host table (the window's rows in a window table)."""
    lo = pool.layout
    key = "win" if lo.win else "full"
    rows = []
    for lane, length in lane_len.items():
        pos = np.arange(max(0, length - lo.win) if lo.win else 0, length)
        slot = pos // lo.page_size % lo.pages_win if lo.win else pos // lo.page_size
        phys = torch.from_numpy(pool._pt[key][lane, slot].astype(np.int64))
        off = torch.from_numpy(pos % lo.page_size)
        rows.append(x[:, phys, off] if name.startswith("body/") else x[phys, off])
    return rows


@pytest.mark.parametrize("arch", list(ARCHS))
def test_int8_pool_matches_the_reference_engine(setups, arch):
    """Three requests over two lanes on an int8 pool, K = 1: after
    admission and three more decode dispatches both packages hold the same
    page tables, and on every live row of every attention (or MLA) layer
    the same int8 codes and bit-equal f16 scales; then both run to the end
    and the greedy streams are token-equal wherever the top-2 margin clears
    ``torch_parity.MARGIN`` (f32)."""
    jeng, teng = _engines(setups, arch)
    _, tcfg, t = setups(arch)
    reqs = list(zip(prompts(3, tcfg.vocab, lo=5, step=6), [8, 6, 7]))
    for eng, sp in ((jeng, JaxSampling), (teng, SamplingParams)):
        for p, n in reqs:
            eng.submit(p, sp(max_new_tokens=n))
    for _ in range(4):
        jeng.step()
        teng.step()
    assert teng.layout.quant and jeng.pool.layout.quant
    for key in teng.cache["tables"]:
        np.testing.assert_array_equal(teng.pool._pt[key], getattr(jeng.pool, f"_pt_{key}"))
    busy = {i: int(teng.cache["len"][i]) for i, s in enumerate(teng.slots) if s is not None}
    assert busy and busy == {i: int(jeng.cache["len"][i]) for i in busy}
    ours, theirs = dict(tree_items(teng.cache)), dict(tree_items(jeng.cache))
    checked = 0
    for name in ours:
        if name.split("/")[-1] not in ("k", "v", "ckv", "krope", "k_scale", "v_scale",
                                       "ckv_scale", "krope_scale"):
            continue
        ref = torch.from_numpy(np.asarray(theirs[name]).copy())
        for a, b in zip(_live_rows(teng.pool, busy, name, ours[name]),
                        _live_rows(teng.pool, busy, name, ref)):
            assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
            checked += a.numel()
    assert checked > 0
    jres, tres = jeng.run(), teng.run()
    for uid, (p, _) in enumerate(reqs):
        assert_streams_agree(tcfg, t["compressed"][1], p, tres[uid].tokens, jres[uid].tokens)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_int8_streams_keep_the_fp_finish_profile(setups, arch):
    """The reference's check (``tests/test_prefix_cache.py:417-433``): int8
    pages may move near-tie greedy picks, but every request finishes with
    the same length and reason as on fp pages."""
    _, tcfg, _ = setups(arch)
    reqs = [(p, SamplingParams(max_new_tokens=6)) for p in prompts(3, tcfg.vocab, lo=5, step=2)]

    def run(quant_on):
        eng = _engines(setups, arch, quant_on)[1]
        uids = [eng.submit(p, sp) for p, sp in reqs]
        res = eng.run()
        return [(len(res[u].tokens), res[u].finish_reason) for u in uids]

    assert run(True) == run(False)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_int8_pool_bytes(setups, arch):
    """One (page, slot) of one layer costs its codes plus a 2-byte scale per
    leaf, against 2 bytes a value at bf16: about half (gpt2-paper at full
    width: 1,540 B against 3,072)."""
    _, tcfg, _ = setups(arch)
    eng = _engines(setups, arch)[1]
    widths = ((tcfg.mla.kv_lora, tcfg.mla.rope_head_dim) if tcfg.mla
              else (tcfg.n_kv * tcfg.hd,) * 2)
    layers = sum(x.shape[0] if n.startswith("body/") else 1 for n, x in tree_items(eng.cache)
                 if n.split("/")[-1] == ("ckv" if tcfg.mla else "k"))
    rows = (eng.layout.num_pages + 1) * eng.layout.page_size  # the sink page included
    # the cache bytes count the RG-LRU layers' per-lane f32 states (W) and
    # conv tails (conv_width - 1 rows of W) too
    rec_layers = sum(max(stack, 1) for _, kind, stack in tmodel._groups(tmodel.layer_plan(tcfg))
                     if kind == "rec")
    states = (rec_layers * eng.max_batch * tcfg.rglru.conv_width * tcfg.rglru.lru_width * 4
              if tcfg.rglru else 0)
    assert eng.kv_cache_bytes() == layers * rows * (sum(widths) + 2 * len(widths)) + states
    assert eng.stats()["kv_quant"] is True


def test_engine_and_cli_refuse_int8_without_a_pool(setups):
    """``kv_quant`` without ``num_pages`` raises (the slab stays fp, so a
    silent slab would fake the byte saving); ``--kv-int8`` without
    ``--paged`` exits with the reference CLI's own message; with ``--paged``
    the CLI serves the reduced model from an int8 pool."""
    _, tcfg, t = setups("gpt2-paper")
    with pytest.raises(ValueError):
        DecodeEngine(tcfg, t["compressed"][1], max_batch=1, max_len=16, kv_quant=True,
                     device="cpu")
    with pytest.raises(SystemExit) as ours:
        launch_serve.main(["--device", "cpu", "--kv-int8"])
    with pytest.raises(SystemExit) as theirs:
        jax_serve.main(["--kv-int8"])
    assert str(ours.value) == str(theirs.value)
    buf = io.StringIO()
    with redirect_stdout(buf):
        summary = launch_serve.main([
            "--device", "cpu", "--batch", "2", "--requests", "3", "--prompt-len", "8",
            "--gen", "8", "--paged", "--page-size", "4", "--num-pages", "8", "--kv-int8"])
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == {"summary": summary}
    assert summary["kv_quant"] is True and summary["generated_tokens"] == 24
    assert summary["kernel_route"] == "plain"
