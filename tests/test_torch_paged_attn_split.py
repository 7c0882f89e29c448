"""The window kernel's split walk, held on the CPU against the JAX package.

On the card the window form of ``paged_attn`` (K2w, its int8 form and K3's
window forms) splits each lane's modular table into ``S`` contiguous slot
ranges, one block each, and merges the blocks' f32 ``(acc, m, l)`` in one
combine.  Here the same partition runs through the plain version: each
range's table keeps its own slots and turns every other slot into the
sentinel, K3's plain version runs on it, and the partials merge, against
the reference's ``paged_attn_xla`` and ``paged_attn_stats_xla`` on the
whole table.  The host rule that picks ``S`` (``window_splits``) is held
as a pure function of the shapes."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn import paged_attn_stats_xla, paged_attn_xla
from repro_torch.kernels.paged_attn import WINDOW_MIN_SLOTS, paged_attn, window_splits
from repro_torch.kernels.sharded import combine_stats_local, merge_stats_local
from repro_torch.models.cache import quant
from torch_parity import win_tables

# f32 on both sides: page-by-page online softmaxes and one merge against one
# gathered softmax, the same sums in other orders
TOL = dict(atol=1e-5, rtol=1e-5)
NEG = np.float32(-1e30)
# ps 4, window 48 over ceil((48 + 4 - 1) / 4) + 1 = 14 slots, so that S = 7
# takes 7 ranges of 2 slots
PS, WIN, N_SLOTS, NUM_PAGES = 4, 48, 14, 64
# lanes: past the window (a partial first page), exactly at it, short of it
# (its pages in the first slots, the later ranges hold nothing), dead
LENGTHS = (61, 48, 9, 0)
DEAD = 3


def _case(int8: bool):
    """Numpy operands of the window form at 4 lanes, 4 query heads over one
    KV head of 16: the tables as the pool keeps them, one page mapped ahead
    of each lane's current page (so lane 0's ahead page sits in the slot of
    its expired page 2: a stale id in an expired slot), and a stale id in
    lane 1's slot of a page not reached yet (page -1)."""
    rng = np.random.default_rng(7 + int8)
    lens = np.asarray(LENGTHS, np.int32)
    tables = win_tables(lens, PS, WIN, N_SLOTS, NUM_PAGES, ahead=1)
    cur = (LENGTHS[1] - 1) // PS
    assert tables[1, (cur + 2) % N_SLOTS] == NUM_PAGES
    tables[1, (cur + 2) % N_SLOTS] = NUM_PAGES - 1  # a stale id before page 0
    q = rng.standard_normal((4, 1, 4, 16)).astype(np.float32)
    pages, kw = [], dict(scale=16 ** -0.5, window=WIN, win_slots=N_SLOTS)
    for name in ("k", "v"):
        x = rng.standard_normal((NUM_PAGES, PS, 1, 16)).astype(np.float32)
        if int8:
            x, sc = (t.numpy() for t in quant(torch.from_numpy(x), 2))
            kw[f"{name}_scale"] = sc
        pages.append(x)
    return q, tuple(pages), tables, lens, kw


def _ranges(n_slots: int, splits: int) -> list:
    """The kernel's partition: block s takes slots [s c, min((s + 1) c, n)),
    c = ceil(n / S)."""
    c = -(-n_slots // splits)
    return [(lo, min(lo + c, n_slots)) for lo in range(0, n_slots, c)]


@pytest.mark.parametrize("splits", [1, 2, 7, N_SLOTS])
@pytest.mark.parametrize("int8", [False, True])
def test_split_window_walk_matches_the_reference(int8, splits):
    """Each range's partial from the plain stats form (the other slots
    sentinel), merged by ``combine_stats_local``, equals the reference's
    ``paged_attn_xla`` on the whole table, and the triple
    ``merge_stats_local`` merges before the divide its
    ``paged_attn_stats_xla``, to 1e-5; ranges with no live row give the
    dead triple and the dead lane stays exact in both flushes."""
    q, pages, tables, lens, kw = _case(int8)
    ranges = _ranges(N_SLOTS, splits)
    assert len(ranges) == splits
    parts = []
    for lo, hi in ranges:
        cut = np.full_like(tables, NUM_PAGES)
        cut[:, lo:hi] = tables[:, lo:hi]
        parts.append(paged_attn(torch.from_numpy(q), *map(torch.from_numpy, pages),
                                torch.from_numpy(cut), torch.from_numpy(lens), emit_stats=True,
                                **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                   for k, v in kw.items()}))
    acc, m, l = (torch.stack(t) for t in zip(*parts))
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jargs = (jnp.asarray(q), *map(jnp.asarray, pages), jnp.asarray(tables), jnp.asarray(lens))
    out = combine_stats_local(acc, m, l)
    np.testing.assert_allclose(out.numpy(), np.asarray(paged_attn_xla(*jargs, **jkw)), **TOL)
    for ours, ref in zip(merge_stats_local(acc, m, l), paged_attn_stats_xla(*jargs, **jkw)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    assert (out[DEAD] == 0).all()
    assert (acc[:, DEAD] == 0).all() and (m[:, DEAD] == NEG).all() and (l[:, DEAD] == 0).all()
    if splits > 2:  # lane 2's 3 pages lie in slots 0-2: the later ranges are empty
        empty = [s for s, (lo, _) in enumerate(ranges) if lo >= 3]
        assert empty and (m[empty, 2] == NEG).all() and (l[empty, 2] == 0).all()


@pytest.mark.parametrize("sms", [16, 114, 132])
def test_window_splits_takes_shapes_only(sms):
    """The host rule over a grid of shapes: 1 <= S <= n_slots, every block
    has slots (the kernel's partition gives exactly S ranges), no more
    blocks than ``ceil(n_slots / WINDOW_MIN_SLOTS)``, about one block per
    SM (fewer than one more block a walk), and S = 1 once the walks fill
    the SMs."""
    for b, hkv, n_slots in itertools.product((1, 2, 4, 5, 9, 33, 64, 200), (1, 2, 8),
                                             (1, 3, 5, 7, 14, 18, 130, 514)):
        s = window_splits(b, hkv, n_slots, sms)
        assert 1 <= s <= n_slots
        assert len(_ranges(n_slots, s)) == s
        if s > 1:
            assert s <= -(-n_slots // WINDOW_MIN_SLOTS)
            assert b * hkv * s < sms + b * hkv
        if b * hkv >= sms:
            assert s == 1


def test_window_splits_at_recurrentgemmas_decode():
    """RecurrentGemma-9B's phase-2 shape (4 lanes, one KV head, 130 slots)
    on 132 SMs: 33 blocks a lane of 4 slots (the last of 2), one wave of
    132 blocks; 132 lanes take one block each."""
    assert window_splits(4, 1, 130, 132) == 33
    assert _ranges(130, 33)[-1] == (128, 130)
    assert window_splits(132, 1, 130, 132) == 1
