"""The stats form of paged decode attention (K3) and its combine, held
against the JAX package on the CPU: K3's plain version (which CPU tensors
take) against ``paged_attn_pallas(emit_stats=True, interpret=True)`` on
``(acc, m, l)`` in f32, in the GQA, window and MLA forms over fp and int8
pages; ``shard_local_tables`` against the reference's; the stacked combine
(``combine_stats_local``) against the reference's ``combine_stats`` under
``jax.vmap`` over a named shard axis; and a pool split into S = 2 and 4
page ranges, K3 on each range and the combine, against the reference's
gathered ``paged_attn_xla`` on the whole pool.  Tolerances are stated by
each test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn import paged_attn_pallas, paged_attn_xla
from repro.kernels.sharded import combine_stats as jax_combine_stats
from repro.kernels.sharded import shard_local_tables as jax_shard_local_tables
from repro_torch.kernels.paged_attn import paged_attn
from repro_torch.kernels.sharded import combine_stats_local, shard_local_tables
from repro_torch.models.cache import quant
from torch_parity import full_tables, win_tables

# f32 on both sides: a page-by-page online softmax against one gathered
# softmax, and one combine's sums in another order
TOL = dict(atol=1e-5, rtol=1e-5)
NEG = np.float32(-1e30)
FORMS = [(form, int8) for form in ("gqa", "window", "mla") for int8 in (False, True)]


def _pages(rng, shape, int8):
    """Random f32 pages, or their int8 codes and f16 ``(P, ps)`` scales."""
    x = rng.standard_normal(shape).astype(np.float32)
    if not int8:
        return x, None
    q, s = quant(torch.from_numpy(x), 2)
    return q.numpy(), s.numpy()


def _case(form: str, int8: bool, num_pages: int = 16):
    """``(q, pages, tables, lens, kw, dead)`` of one form on numpy operands
    (``pages`` = ``(k_pages, v_pages or None)``; ``kw`` the keywords, scale
    planes among them; ``dead`` the idle lane).  Lanes are ragged; the
    window form has lanes past the window, a stale id in an expired slot
    and an unmapped slot in a live range; the MLA form an unmapped slot in
    a live range."""
    rng = np.random.default_rng({"gqa": 1, "window": 2, "mla": 3}[form] + 10 * int8)
    b, ps = 4, 4
    if form == "gqa":
        hkv, g, d = 2, 3, 16
        lens = np.asarray([1, 7, 21, 0], np.int32)
        tables = full_tables(lens, ps, 6, num_pages)
        (kp, ks), (vp, vs) = (_pages(rng, (num_pages, ps, hkv, d), int8) for _ in range(2))
        q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
        kw = dict(scale=d ** -0.5)
        if int8:
            kw.update(k_scale=ks, v_scale=vs)
        return q, (kp, vp), tables, lens, kw, 3
    if form == "window":
        g, d, win = 4, 16, 10
        win_slots = -(-(win + 4 - 1) // ps) + 1
        lens = np.asarray([21, 17, 0, 30], np.int32)
        tables = win_tables(lens, ps, win, win_slots, num_pages)
        tables[0, 1] = num_pages - 1  # page 1 expired: a stale id
        tables[1, 2] = num_pages  # lane 1's page 2 unmapped
        (kp, ks), (vp, vs) = (_pages(rng, (num_pages, ps, 1, d), int8) for _ in range(2))
        q = rng.standard_normal((b, 1, g, d)).astype(np.float32)
        kw = dict(scale=d ** -0.5, window=win, win_slots=win_slots)
        if int8:
            kw.update(k_scale=ks, v_scale=vs)
        return q, (kp, vp), tables, lens, kw, 2
    h, latent, rd = 4, 16, 8
    lens = np.asarray([5, 19, 0, 12], np.int32)
    tables = full_tables(lens, ps, 5, num_pages)
    tables[1, 2] = num_pages  # an unmapped slot inside lane 1's live range
    (cp, cs), (rp, rs) = _pages(rng, (num_pages, ps, 1, latent), int8), _pages(
        rng, (num_pages, ps, 1, rd), int8)
    q = rng.standard_normal((b, 1, h, latent)).astype(np.float32)
    q2 = rng.standard_normal((b, 1, h, rd)).astype(np.float32)
    kw = dict(scale=0.17, q2=q2, k2_pages=rp, v_is_k=True)
    if int8:
        kw.update(k_scale=cs, k2_scale=rs)
    return q, (cp, None), tables, lens, kw, 2


def _jax(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _torch(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("form,int8", FORMS)
def test_k3_plain_matches_pallas_interpret(form, int8):
    """K3's ``(acc, m, l)`` against the Pallas kernel's stats flush in
    interpret mode on the same operands, to 1e-5; the idle lane is exactly
    ``(0, -1e30, 0)`` on both sides."""
    q, pages, tables, lens, kw, dead = _case(form, int8)
    ref = paged_attn_pallas(_jax(q), *(_jax(p) for p in pages), _jax(tables), _jax(lens),
                            interpret=True, emit_stats=True, **{k: _jax(v) for k, v in kw.items()})
    ours = paged_attn(_torch(q), *(_torch(p) for p in pages), _torch(tables), _torch(lens),
                      emit_stats=True, **{k: _torch(v) for k, v in kw.items()})
    for y, r in zip(ours, ref):
        assert y.dtype == torch.float32 and tuple(y.shape) == r.shape
        np.testing.assert_allclose(y.numpy(), np.asarray(r), **TOL)
    acc, m, l = (y[dead].numpy() for y in ours)
    assert (acc == 0).all() and (m == NEG).all() and (l == 0).all()
    assert (np.asarray(ref[1][dead]) == NEG).all()


@pytest.mark.parametrize("shards", [2, 4])
def test_shard_local_tables_match_the_reference(shards):
    """Local ids, the resident mask and the local sentinel equal the
    reference's on every shard: a lane with no page on some shards, a lane
    with pages on all of them, idle lanes and the global sentinel."""
    per, n_slots = 4, 6
    num_pages = per * shards
    tables = np.full((4, n_slots), num_pages, np.int32)
    tables[0, :3] = [0, 1, 2]  # shard 0 only
    tables[1, :n_slots] = np.arange(n_slots) * (num_pages // n_slots + 1) % num_pages
    tables[2, 1] = num_pages - 1  # one page on the last shard, sentinel around it
    for shard in range(shards):
        local, resident = shard_local_tables(torch.from_numpy(tables), shard, per)
        ref_local, ref_resident = jax_shard_local_tables(jnp.asarray(tables), shard, per)
        np.testing.assert_array_equal(local.numpy(), np.asarray(ref_local))
        np.testing.assert_array_equal(resident.numpy(), np.asarray(ref_resident))
        assert local.dtype == torch.int32
        assert (local.numpy()[3] == per).all()  # the idle lane: all local sentinel
    assert not shard_local_tables(torch.from_numpy(tables), 1, per)[1][0].any()


@pytest.mark.parametrize("shards", [2, 4])
def test_combine_matches_the_reference_under_vmap(shards):
    """The stacked combine against the reference's ``combine_stats`` run
    under ``jax.vmap(axis_name="model")`` over the same ``(S, ...)`` stats,
    to 1e-6: live shards, dead shards (``m = -1e30, l = 0, acc = 0``) and a
    lane dead on every shard, which must give exact zeros."""
    rng = np.random.default_rng(shards)
    b, h, g, d = 3, 2, 2, 8
    m = rng.standard_normal((shards, b, h, g)).astype(np.float32)
    l = rng.uniform(0.5, 4.0, (shards, b, h, g)).astype(np.float32)
    acc = rng.standard_normal((shards, b, h, g, d)).astype(np.float32)
    m[1:, 0], l[1:, 0], acc[1:, 0] = NEG, 0.0, 0.0  # lane 0 lives on shard 0 only
    m[:, 2], l[:, 2], acc[:, 2] = NEG, 0.0, 0.0  # lane 2 dead everywhere
    ref = jax.vmap(lambda a, mm, ll: jax_combine_stats(a, mm, ll, "model"),
                   axis_name="model")(jnp.asarray(acc), jnp.asarray(m), jnp.asarray(l))
    ours = combine_stats_local(torch.from_numpy(acc), torch.from_numpy(m), torch.from_numpy(l))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref)[0], atol=1e-6, rtol=1e-6)
    assert (ours[2] == 0).all()
    np.testing.assert_allclose(ours[0].numpy(), acc[0, 0] / l[0, 0][..., None], rtol=1e-6)


@pytest.mark.parametrize("form,int8", FORMS)
def test_split_pool_combined_matches_the_whole_pool(form, int8):
    """The pool cut into S = 2 and 4 page ranges (pages, scale planes and
    the second stream alike), each range's table remapped by
    ``shard_local_tables``, K3 on each and the stacked combine, against the
    reference's ``paged_attn_xla`` on the whole pool, to 1e-5 (f32); the
    idle lane exactly zero."""
    q, pages, tables, lens, kw, dead = _case(form, int8)
    ref = np.asarray(paged_attn_xla(_jax(q), *(_jax(p) for p in pages), _jax(tables),
                                    _jax(lens), **{k: _jax(v) for k, v in kw.items()}))
    pooled = ("k2_pages", "k_scale", "v_scale", "k2_scale")
    for shards in (2, 4):
        per = pages[0].shape[0] // shards
        stats = []
        for s in range(shards):
            cut = slice(s * per, (s + 1) * per)
            local, _ = shard_local_tables(torch.from_numpy(tables), s, per)
            skw = {k: _torch(v[cut] if k in pooled else v) for k, v in kw.items()}
            stats.append(paged_attn(_torch(q), *(None if p is None else _torch(p[cut])
                                                 for p in pages),
                                    local, _torch(lens), emit_stats=True, **skw))
        out = combine_stats_local(*(torch.stack(t) for t in zip(*stats)))
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
        assert (out[dead] == 0).all()
