"""The port's ``paged_attn`` (its plain version, which CPU tensors take)
held against the JAX Pallas kernel in interpret mode, on the ragged lanes,
sentinel slots and idle lane of ``tests/test_paged_attn.py``: the MHA/GQA
form, its window option over modular tables (K2w: ``window``/
``win_slots``) and the MLA latent form (K2m: ``q2``/``k2_pages``/
``v_is_k``); and which options and operands the wrapper refuses.  The
int8-scale option (K2q) is held in ``tests/test_torch_kv_int8.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn import paged_attn_pallas
from repro_torch.kernels.paged_attn import paged_attn
from repro_torch.models.layers import decode_attention
from torch_parity import full_tables, win_tables

# f32 on both sides: page-by-page online softmax vs one gathered softmax
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hkv,g", [(4, 1), (2, 3)])  # MHA, GQA
def test_plain_matches_pallas_interpret(hkv, g):
    b, d, ps, num_pages, n_slots = 4, 16, 4, 12, 6
    lengths = [1, 7, 21, 0]  # partial page / multi-page / near-cap / idle
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    tables = full_tables(lengths, ps, n_slots, num_pages)
    lens = np.asarray(lengths, np.int32)
    scale = d ** -0.5
    y_ref = paged_attn_pallas(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                              jnp.asarray(tables), jnp.asarray(lens), scale=scale,
                              interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, kp, vp))
    y = paged_attn(tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(lens),
                   scale=scale)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    assert float(y[3].abs().max()) == 0.0  # idle lane: exact zeros
    # and against slab decode attention over each lane's gathered pages
    for i, ln in enumerate(lengths[:3]):
        pages = torch.from_numpy(tables[i, : -(-ln // ps)]).long()
        ref = decode_attention(tq[i].reshape(1, 1, hkv * g, d),
                               tk[pages].reshape(1, -1, hkv, d),
                               tv[pages].reshape(1, -1, hkv, d), torch.tensor([ln]))
        np.testing.assert_allclose(y[i].reshape(1, 1, hkv * g, d).numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("case", ["slid", "pg_below_zero", "stale_and_sentinel"])
def test_window_form_matches_pallas_interpret(case):
    """K2w (Hkv = 1, G = 4): lanes past the window with a partial first
    page; lanes short of the window whose page mapped ahead of the write
    sits in a slot that reads as a page before 0 (``pg < 0``); a stale slot
    (an expired page's id left behind) and a sentinel slot; an idle lane; against the Pallas kernel and against slab decode attention
    over each lane's last ``window`` positions."""
    b, hkv, g, d, ps, win = 4, 1, 4, 16, 4, 10
    win_slots = -(-(win + 4 - 1) // ps) + 1  # the pool's at K = 4: 5
    lengths = {"slid": [23, 13, 0, 30], "pg_below_zero": [3, 6, 0, 1],
               "stale_and_sentinel": [21, 17, 0, 9]}[case]
    num_pages = 4 * win_slots + 1
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    tables = win_tables(lengths, ps, win, win_slots, num_pages,
                         ahead=0 if case == "stale_and_sentinel" else 1)
    if case == "stale_and_sentinel":
        # lane 0 (len 21, window [11, 21)): slot of page 0 keeps an old id
        # (page 0 is 5 pages back, aliasing page 5's slot 0: not mapped)
        tables[0, 1] = num_pages - 1  # slot 1 = page 1, expired: a stale id
        tables[1, 2] = num_pages  # lane 1 (len 17): page 2's slot unmapped
    lens = np.asarray(lengths, np.int32)
    scale = d ** -0.5
    y_ref = paged_attn_pallas(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                              jnp.asarray(tables), jnp.asarray(lens), scale=scale,
                              window=win, win_slots=win_slots, interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, kp, vp))
    y = paged_attn(tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(lens),
                   scale=scale, window=win, win_slots=win_slots)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    assert float(y[2].abs().max()) == 0.0  # idle lane: exact zeros
    for i, ln in enumerate(lengths):
        pos = np.arange(max(0, ln - win), ln)
        if ln == 0 or (tables[i, (pos // ps) % win_slots] == num_pages).any():
            continue  # the sentinel case drops positions: the kernel's answer only
        rows = torch.from_numpy(tables[i, (pos // ps) % win_slots]).long()
        a = torch.from_numpy(pos % ps)
        ref = decode_attention(tq[i].reshape(1, 1, hkv * g, d), tk[rows, a][None],
                               tv[rows, a][None], torch.tensor([len(pos)]))
        np.testing.assert_allclose(y[i].reshape(1, 1, hkv * g, d).numpy(), ref.numpy(), **TOL)


def test_mla_form_matches_pallas_interpret():
    """K2m at the reference's own case's layout (Hkv = 1, G = H, V is the
    latent pool): ragged lanes, a sentinel slot inside a live range and a
    dead lane, f32 queries and output."""
    b, h, latent, rd, ps, num_pages, n_slots = 4, 4, 16, 8, 4, 12, 5
    lengths = [5, 19, 0, 12]
    rng = np.random.default_rng(3)
    ql, q2 = (rng.standard_normal((b, 1, h, w)).astype(np.float32) for w in (latent, rd))
    c_pages = rng.standard_normal((num_pages, ps, 1, latent)).astype(np.float32)
    r_pages = rng.standard_normal((num_pages, ps, 1, rd)).astype(np.float32)
    tables = full_tables(lengths, ps, n_slots, num_pages)
    tables[1, 2] = num_pages  # an unmapped slot inside lane 1's live range
    lens = np.asarray(lengths, np.int32)
    scale = 0.17
    y_ref = paged_attn_pallas(jnp.asarray(ql), jnp.asarray(c_pages), None,
                              jnp.asarray(tables), jnp.asarray(lens), scale=scale,
                              q2=jnp.asarray(q2), k2_pages=jnp.asarray(r_pages),
                              v_is_k=True, interpret=True)
    y = paged_attn(*(torch.from_numpy(a) for a in (ql, c_pages)), None,
                   torch.from_numpy(tables), torch.from_numpy(lens), scale=scale,
                   q2=torch.from_numpy(q2), k2_pages=torch.from_numpy(r_pages), v_is_k=True)
    assert y.shape == (b, 1, h, latent) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    assert float(y[2].abs().max()) == 0.0  # dead lane: exact zeros


def test_unported_options_are_refused():
    """K2m, K2w, K2q and the stats option (K3) are ported: the stats triple
    normalizes to the plain output.  Int8 pages take exactly their form's ``(P, ps)`` scale planes
    (K and V; K and K2 for MLA), and fp pages none.  A window needs
    ``win_slots`` equal to the table's width, and is not taken by the MLA
    form."""
    q = torch.zeros((1, 1, 1, 4))
    pages = torch.zeros((2, 4, 1, 4))
    codes = torch.zeros((2, 4, 1, 4), dtype=torch.int8)
    sc = torch.ones((2, 4), dtype=torch.float16)
    tl = (torch.zeros((1, 2), dtype=torch.int32), torch.ones(1, dtype=torch.int32))
    args = (q, pages, pages, *tl)
    acc, m, l = paged_attn(*args, scale=0.5, emit_stats=True)
    assert acc.shape == (1, 1, 1, 4) and m.shape == l.shape == (1, 1, 1)
    assert torch.equal(acc / l.clamp_min(1e-30)[..., None], paged_attn(*args, scale=0.5))
    for bad in (
        dict(k_scale=sc, v_scale=sc),  # scales without int8 pages
        dict(codes=True),  # int8 pages without their scales
        dict(codes=True, k_scale=sc),  # V's plane missing
        dict(codes=True, k_scale=sc, v_scale=sc, k2_scale=sc),  # no K2 stream here
        dict(codes=True, k_scale=sc, v_scale=sc[:1]),  # not (P, ps)
        dict(codes=True, k_scale=sc.reshape(1, 8), v_scale=sc),
    ):
        kp = codes if bad.pop("codes", False) else pages
        with pytest.raises(ValueError):
            paged_attn(q, kp, kp, *tl, scale=0.5, **bad)
    mla = dict(q2=q, k2_pages=codes, v_is_k=True)
    for bad in (dict(k_scale=sc), dict(k_scale=sc, v_scale=sc), dict(k2_scale=sc)):
        with pytest.raises(ValueError):
            paged_attn(q, codes, None, *tl, scale=0.5, **mla, **bad)
    assert paged_attn(q, codes, None, *tl, scale=0.5, k_scale=sc, k2_scale=sc,
                      **mla).shape == (1, 1, 1, 4)
    assert paged_attn(q, codes, codes, *tl, scale=0.5, k_scale=sc,
                      v_scale=sc).shape == (1, 1, 1, 4)
    for option in (dict(window=4, win_slots=3), dict(window=4), dict(win_slots=2)):
        with pytest.raises(ValueError):
            paged_attn(*args, scale=0.5, **option)
    for stats in (False, True):  # the window option stays refused on the MLA form
        with pytest.raises(ValueError):
            paged_attn(q, pages, None, *tl, scale=0.5, window=4, win_slots=2, q2=q,
                       k2_pages=pages, v_is_k=True, emit_stats=stats)
    assert paged_attn(*args, scale=0.5, window=4, win_slots=2).shape == (1, 1, 1, 4)
