"""The CUDA kernels against their plain PyTorch versions on the card, over
shapes and patterns beyond the main path's.  Needs a CUDA card and
``nvcc``; skips without one.  Imports no JAX, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.nm_mask import nm_mask, nm_mask_plain
from repro_torch.kernels.nm_spmm import (
    nm_spmm,
    nm_spmm_batched,
    nm_spmm_batched_plain,
    nm_spmm_plain,
)
from repro_torch.kernels import paged_attn_check
from repro_torch.kernels.paged_attn import (
    paged_attn,
    paged_attn_plain,
    paged_attn_stats_plain,
    sm_count,
    window_splits,
)
from repro_torch.sparse_infer import CompressedTensor

pytestmark = pytest.mark.gpu

# f32: the kernel and the plain version sum the same products in other orders.
# bf16: both round their f32 result to bf16 once; one bf16 step is 2^-8 relative.
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _compressed(k, o, n, m, pad, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    g = k // m
    # n distinct ascending offsets per (group, column), as nm_compress stores them
    idx = torch.rand((g, m, o), generator=gen).argsort(dim=1)[:, :n].sort(dim=1).values
    idx = idx.reshape(g * n, o).to(torch.uint8)
    vals = torch.randn((g * n, o), generator=gen).to(dtype)
    if pad:
        vals = torch.cat([vals, torch.zeros((g * n, pad), dtype=dtype)], 1)
        idx = torch.cat([idx, torch.zeros((g * n, pad), dtype=torch.uint8)], 1)
    return vals.to(dev).contiguous(), idx.to(dev).contiguous()


# (k, o, n, m, pad, stack): stack > 0 takes .layer(1) of that many stacked leaves
NM_SPMM_SHAPES = [
    (64, 40, 2, 4, 0, 0), (64, 40, 1, 4, 24, 0), (512, 96, 2, 8, 0, 0), (512, 64, 4, 16, 8, 0),
    (768, 768, 2, 4, 0, 0), (3072, 768, 2, 4, 0, 0),  # gpt2-paper
    (320, 64, 2, 64, 0, 0), (384, 64, 1, 128, 0, 0),  # fewer than 8 groups a chunk
    (768, 3072, 2, 4, 0, 2),  # .layer(1) of a stack of two: a view Kc*O elements in
    (256, 37, 2, 4, 0, 0), (256, 37, 1, 4, 0, 3),  # O not a multiple of 32
    (512, 10240, 2, 4, 0, 0), (512, 10240, 2, 4, 8, 0),  # 4 columns a lane, a padded tail
]
# RecurrentGemma-9B's MLP, in bf16 as it is served (f32 sums of its 12288
# products in two orders differ by more than TOL's f32 1e-4 near zero);
# 12288 columns of x at B = 8 exceed the decode kernel's staging budget
NM_SPMM_RG_SHAPES = [(4096, 12288, 2, 4, 0, 0), (12288, 4096, 2, 4, 0, 0)]


@pytest.mark.parametrize("dtype,b,k,o,n,m,pad,stack", [
    (dtype, b, *shape) for shape in NM_SPMM_SHAPES for b in (1, 3, 4, 8, 9, 40)
    for dtype in (torch.float32, torch.bfloat16)
] + [(torch.bfloat16, b, *shape) for shape in NM_SPMM_RG_SHAPES for b in (1, 4, 8, 9)])
def test_nm_spmm_kernel_matches_plain(dev, dtype, b, k, o, n, m, pad, stack):
    if stack:
        parts = [_compressed(k, o, n, m, pad, dtype, dev, seed=s) for s in range(stack)]
        leaf = CompressedTensor(torch.stack([v for v, _ in parts]),
                                torch.stack([i for _, i in parts]), n, m, -2,
                                (stack, k, o + pad), pad=pad)
        vals, idx = leaf.layer(1).values, leaf.layer(1).indices
        assert vals.storage_offset() == k * n // m * (o + pad)
    else:
        vals, idx = _compressed(k, o, n, m, pad, dtype, dev)
    x = torch.randn((b, k), generator=torch.Generator().manual_seed(1)).to(dtype).to(dev)
    before = dispatch.launches["nm_spmm"]
    y = nm_spmm(x, vals, idx, n, m, o_true=o)
    torch.cuda.synchronize()
    assert dispatch.launches["nm_spmm"] == before + 1
    ref = nm_spmm_plain(x, vals, idx, n, m, o_true=o)
    assert y.shape == (b, o) and y.dtype == dtype
    torch.testing.assert_close(y.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("batched,e,b,k,o", [
    (False, 1, 4, 12288, 4096), (False, 1, 8, 768, 768), (False, 1, 3, 256, 37),
    (True, 64, 8, 2048, 1408), (True, 4, 8, 512, 96),
    # prefill: the tensor-core body
    (False, 1, 40, 768, 768), (False, 1, 130, 4096, 4608), (True, 64, 32, 2048, 1408),
])
def test_nm_spmm_kernel_is_deterministic(dev, batched, e, b, k, o):
    """The same call twice gives the same bytes: sums in a fixed order, no
    atomics."""
    stacks = [_compressed(k, o, 2, 4, 0, torch.bfloat16, dev, seed=s) for s in range(e)]
    vals = torch.stack([v for v, _ in stacks])
    idx = torch.stack([i for _, i in stacks])
    x = torch.randn((e, b, k), generator=torch.Generator().manual_seed(3)).bfloat16().to(dev)
    if batched:
        first, second = (nm_spmm_batched(x, vals, idx, 2, 4) for _ in range(2))
    else:
        first, second = (nm_spmm(x[0], vals[0], idx[0], 2, 4) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.uint8), second.view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batched,e,k,o", [
    (False, 1, 768, 768), (False, 1, 3072, 768), (False, 1, 256, 37), (True, 8, 512, 96),
    (False, 1, 320, 64),
])
def test_nm_spmm_row_does_not_depend_on_its_batch(dev, dtype, batched, e, k, o):
    """A row of x gives the same bytes whatever rows share its call and
    wherever it sits in it: in decode (1, 4 and 7 rows against an 8-row
    call: the decode kernel), in prefill (9, 17 and 40 rows against a
    64-row call, and rows 70-101 and 300-331 of a 512-row call, across
    warps and row tiles: the tensor-core body in bf16, the first version's
    body in f32), each summing every output in one order fixed by the
    weight's shapes; in f32 decode and prefill share that order (1, 4 and
    7 rows against the 64-row call)."""
    m = 64 if k == 320 else 4
    stacks = [_compressed(k, o, 2, m, 0, dtype, dev, seed=s) for s in range(e)]
    vals = torch.stack([v for v, _ in stacks])
    idx = torch.stack([i for _, i in stacks])
    x = torch.randn((e, 512, k), generator=torch.Generator().manual_seed(4)).to(dtype).to(dev)

    def call(lo, hi):
        xr = x[:, lo:hi].contiguous()
        return (nm_spmm_batched(xr, vals, idx, 2, m) if batched
                else nm_spmm(xr[0], vals[0], idx[0], 2, m)[None])

    cases = [(8, (1, 4, 7)), (64, (9, 17, 40))]
    if dtype == torch.float32:
        cases.append((64, (1, 4, 7)))
    for whole, parts in cases:
        full = call(0, whole)
        for rows in parts:
            assert torch.equal(call(0, rows).view(torch.uint8), full[:, :rows].view(torch.uint8))
    full = call(0, 512)
    for lo in (70, 300):
        assert torch.equal(call(lo, lo + 32).view(torch.uint8),
                           full[:, lo:lo + 32].view(torch.uint8))


def _within_one_bf16_step(y, ref):
    """Both round an f32 sum to bf16 once, summed in other orders: they may
    land one bf16 step (at most 2^-7 of the value) apart, and 1e-5 covers
    sums near 0."""
    err = (y.float() - ref.float()).abs()
    bad = err > 2.0 ** -7 * ref.float().abs() + 1e-5
    assert not bool(bad.any()), f"{int(bad.sum())} of {bad.numel()} beyond one bf16 step"


# (batched, e, b, k, o, n, m, pad): B no multiple of 16; o_true < O (pad);
# K no multiple of the step (64 for m <= 64); rows of x (K % 8) or of the
# weight (O % 16) that take plain loads; an odd o_true; each tile
TC_SHAPES = [
    (False, 1, 9, 64, 40, 2, 4, 24), (False, 1, 37, 96, 130, 2, 4, 0),
    (False, 1, 130, 36, 77, 1, 4, 3), (False, 1, 200, 768, 3072, 2, 4, 0),
    (False, 1, 33, 512, 96, 2, 8, 0), (False, 1, 65, 320, 64, 16, 64, 0),
    (False, 1, 20, 384, 64, 1, 128, 0), (False, 1, 100, 1024, 4608, 2, 4, 0),
    (False, 1, 47, 192, 48, 6, 12, 0),  # m of 12: steps of 96 columns
    (False, 1, 20, 768, 3072, 4, 8, 0),  # a 4:8 verify chunk of 4 lanes x 5 rows
    (False, 1, 20, 3072, 768, 4, 8, 0),
    (True, 3, 17, 64, 40, 2, 4, 24), (True, 3, 45, 96, 130, 1, 4, 0),
    (True, 3, 12, 512, 96, 2, 8, 0), (True, 64, 32, 2048, 1408, 2, 4, 0),
]


@pytest.mark.parametrize("batched,e,b,k,o,n,m,pad", TC_SHAPES)
def test_nm_spmm_tensor_core_body_within_one_bf16_step(dev, batched, e, b, k, o, n, m, pad):
    """K1's and K1b's prefill body (bf16, more than 8 rows) against the
    plain version within one bf16 step, at ragged shapes; two calls give
    the same bytes."""
    stacks = [_compressed(k, o, n, m, pad, torch.bfloat16, dev, seed=s) for s in range(e)]
    vals = torch.stack([v for v, _ in stacks])
    idx = torch.stack([i for _, i in stacks])
    x = torch.randn((e, b, k), generator=torch.Generator().manual_seed(5)).bfloat16().to(dev)
    name = "nm_spmm_batched" if batched else "nm_spmm"
    before = dispatch.launches[name]
    if batched:
        y, again = (nm_spmm_batched(x, vals, idx, n, m, o_true=o) for _ in range(2))
        ref = nm_spmm_batched_plain(x, vals, idx, n, m, o_true=o)
    else:
        y, again = (nm_spmm(x[0], vals[0], idx[0], n, m, o_true=o) for _ in range(2))
        ref = nm_spmm_plain(x[0], vals[0], idx[0], n, m, o_true=o)
    torch.cuda.synchronize()
    assert dispatch.launches[name] == before + 2
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert torch.equal(y.view(torch.uint8), again.view(torch.uint8))
    _within_one_bf16_step(y, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,g,d,ps", [(12, 1, 64, 16), (2, 3, 16, 4), (4, 4, 128, 8),
                                        (1, 2, 256, 64),  # f32: one stage, no ring
                                        (2, 1, 64, 256),  # pages of the kernel's 256 rows
                                        (2, 2, 5, 5)])  # bf16 rows of 10 bytes, odd ps
def test_paged_attn_kernel_matches_plain(dev, dtype, hkv, g, d, ps):
    lengths = [1, 2 * ps + 3, 5 * ps, 0, 3 * ps - 1]  # ragged, page-aligned, idle
    n_slots, num_pages = 6, 24
    gen = torch.Generator().manual_seed(0)
    perm = torch.randperm(num_pages, generator=gen).tolist()
    tables = np.full((len(lengths), n_slots), num_pages, np.int32)
    for i, ln in enumerate(lengths):
        for pg in range(-(-ln // ps)):
            tables[i, pg] = perm.pop()
    tables[4, 1] = num_pages  # an unmapped slot inside a live range is skipped
    q = torch.randn((len(lengths), hkv, g, d), generator=gen).to(dtype).to(dev)
    kp = torch.randn((num_pages, ps, hkv, d), generator=gen).to(dtype).to(dev)
    vp = torch.randn((num_pages, ps, hkv, d), generator=gen).to(dtype).to(dev)
    t = torch.from_numpy(tables).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = dispatch.launches["paged_attn"]
    y = paged_attn(q, kp, vp, t, lens, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert dispatch.launches["paged_attn"] == before + 1
    ref = paged_attn_plain(q, kp, vp, t, lens, scale=d ** -0.5)
    torch.testing.assert_close(y.float(), ref.float(), **TOL[dtype])
    assert float(y[3].abs().max()) == 0.0  # idle lane: exact zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,b,k,o,pad", [(3, 1, 64, 40, 24), (4, 8, 512, 96, 0),
                                         (64, 8, 2048, 1408, 0), (8, 32, 1408, 2048, 0)])
def test_nm_spmm_batched_kernel_matches_plain(dev, dtype, e, b, k, o, pad):
    """The expert-batched K1: one launch over E stacked products."""
    stacks = [_compressed(k, o, 2, 4, pad, dtype, dev, seed=s) for s in range(e)]
    vals = torch.stack([v for v, _ in stacks])
    idx = torch.stack([i for _, i in stacks])
    x = torch.randn((e, b, k), generator=torch.Generator().manual_seed(2)).to(dtype).to(dev)
    before = dict(dispatch.launches)
    y = nm_spmm_batched(x, vals, idx, 2, 4, o_true=o)
    torch.cuda.synchronize()
    assert dispatch.launches["nm_spmm_batched"] == before["nm_spmm_batched"] + 1
    assert dispatch.launches["nm_spmm"] == before["nm_spmm"]
    ref = nm_spmm_batched_plain(x, vals, idx, 2, 4, o_true=o)
    assert y.shape == (e, b, o) and y.dtype == dtype
    torch.testing.assert_close(y.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("page_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d,d2,ps,extra_lanes", [
    (4, 16, 8, 4, 0), (16, 512, 64, 16, 0),
    (4, 16, 8, 256, 0),  # pages of the kernel's 256 rows
    (3, 6, 3, 3, 0),  # a latent of 6 (no multiple of a lane's 4 columns), odd ps
    (16, 512, 64, 16, 11),  # 16 lanes: 4 heads a block, 55 KB of shared memory
    (16, 512, 64, 16, 59),  # 64 lanes: 16 heads a block, 105 KB
])
def test_paged_attn_mla_kernel_matches_plain(dev, page_dtype, g, d, d2, ps, extra_lanes):
    """K2m: f32 queries and output over pages of either type, V is the
    latent page; with more lanes a block keeps more heads, and past 48 KB
    of shared memory the launch opts in."""
    gen = torch.Generator().manual_seed(1)
    lengths = [1, 2 * ps + 3, 5 * ps, 0, 3 * ps - 1] + torch.randint(
        0, 5 * ps + 1, (extra_lanes,), generator=gen).tolist()
    n_slots, num_pages = 6, 24 + 5 * extra_lanes
    perm = torch.randperm(num_pages, generator=gen).tolist()
    tables = np.full((len(lengths), n_slots), num_pages, np.int32)
    for i, ln in enumerate(lengths):
        for pg in range(-(-ln // ps)):
            tables[i, pg] = perm.pop()
    tables[4, 1] = num_pages  # an unmapped slot inside a live range is skipped
    q, q2 = (torch.randn((len(lengths), 1, g, w), generator=gen).to(dev) for w in (d, d2))
    kp, k2p = (torch.randn((num_pages, ps, 1, w), generator=gen).to(page_dtype).to(dev)
               for w in (d, d2))
    t = torch.from_numpy(tables).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = (d + d2) ** -0.5
    before = dict(dispatch.launches)
    y = paged_attn(q, kp, None, t, lens, scale=scale, q2=q2, k2_pages=k2p, v_is_k=True)
    torch.cuda.synchronize()
    assert dispatch.launches["paged_attn_mla"] == before["paged_attn_mla"] + 1
    assert dispatch.launches["paged_attn"] == before["paged_attn"]
    ref = paged_attn_plain(q, kp, None, t, lens, scale=scale, q2=q2, k2_pages=k2p, v_is_k=True)
    assert y.dtype == torch.float32 and y.shape == (len(lengths), 1, g, d)
    torch.testing.assert_close(y, ref, **TOL[torch.float32])
    assert float(y[3].abs().max()) == 0.0  # idle lane: exact zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d,ps,win,extra_lanes,split", [
    (4, 16, 4, 10, 0, True),  # 5 slots over 2 blocks a lane
    (16, 256, 16, 64, 0, True), (16, 256, 16, 64, 59, True),  # 6 slots over 2 blocks
    (4, 16, 4, 40, 0, True),  # 12 slots over 3 blocks a lane
    (16, 256, 16, 256, 0, True),  # 18 slots over 5 blocks a lane
    (16, 256, 16, 256, 27, True),  # 32 ragged lanes, 3-4 blocks each
    (16, 256, 16, 256, 135, False),  # 140 lanes fill the card: one block each
])
def test_paged_attn_window_kernel_matches_plain(dev, dtype, g, d, ps, win, extra_lanes, split):
    """K2w over a modular table: lanes past the window (a partial first
    page), short of it with a page mapped ahead (a slot reading as a page
    before 0), a stale id in an expired slot, an unmapped slot, an idle
    lane; tables split over several blocks a lane (``split``: S > 1,
    partials merged by the combine) or walked by one (S = 1)."""
    gen = torch.Generator().manual_seed(2)
    win_slots = -(-(win + 4 - 1) // ps) + 1
    n_lanes = 5 + extra_lanes
    assert (window_splits(n_lanes, 1, win_slots, sm_count(dev)) > 1) == split
    lengths = [win + 3 * ps + 5, win - 3, 0, 2 * ps + 1, win + 7 * ps] + torch.randint(
        0, 3 * win, (extra_lanes,), generator=gen).tolist()
    num_pages = win_slots * len(lengths) + 1
    perm = torch.randperm(num_pages, generator=gen).tolist()
    tables = np.full((len(lengths), win_slots), num_pages, np.int32)
    for i, ln in enumerate(lengths):
        if ln:
            for pg in range(max(0, ln - win) // ps, (ln - 1) // ps + 2):
                tables[i, pg % win_slots] = perm.pop()
    cur = (lengths[4] - 1) // ps
    tables[4, (cur + 2) % win_slots] = perm.pop()  # a slot reading as an expired page: stale id
    tables[0, ((lengths[0] - 1) // ps - 1) % win_slots] = num_pages  # unmapped, live range
    q = torch.randn((len(lengths), 1, g, d), generator=gen).to(dtype).to(dev)
    kp, vp = (torch.randn((num_pages, ps, 1, d), generator=gen).to(dtype).to(dev)
              for _ in range(2))
    t = torch.from_numpy(tables).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(scale=d ** -0.5, window=win, win_slots=win_slots)
    before = dict(dispatch.launches)
    y = paged_attn(q, kp, vp, t, lens, **kw)
    torch.cuda.synchronize()
    assert dispatch.launches["paged_attn_win"] == before["paged_attn_win"] + 1
    assert dispatch.launches["paged_attn"] == before["paged_attn"]
    ref = paged_attn_plain(q, kp, vp, t, lens, **kw)
    torch.testing.assert_close(y.float(), ref.float(), **TOL[dtype])
    assert float(y[2].abs().max()) == 0.0  # idle lane: exact zeros


def _int8(pages):
    """The port's int8 codes and f16 ``(P, ps)`` scales of fp pages."""
    from repro_torch.models.cache import quant

    return quant(pages, 2)


def _form_case(dev, form, lanes, int8=True):
    """Operands of one ``paged_attn`` form: GQA at gpt2-paper's heads (12
    KV heads of 64, ps 16), the window form at RecurrentGemma's (16 query
    heads over one KV head of 256, window 64 over a modular table of 6
    slots with a stale and an unmapped slot; ``window_wide``: window 256
    over 18 slots; the kernel splits either over several blocks a lane at
    these lane counts) and the MLA form at DeepSeek's (16 heads, latent 512, RoPE
    64, f32 queries and output); ragged lanes with an idle one; pages of
    bf16, or int8 made by the port's own ``quant``.  Returns ``(args, kw,
    entry, dtype, idle)``, ``entry`` the form's launch entry of the
    normalized flush."""
    gen = torch.Generator().manual_seed(3)
    ps = 16
    if form.startswith("window"):
        g, d, win = 16, 256, 256 if form == "window_wide" else 64
        n_slots = -(-(win + 4 - 1) // ps) + 1
        lengths = [win + 3 * ps + 5, win - 3, 0, 2 * ps + 1, win + 7 * ps]
    else:
        n_slots, win = 6, 0
        lengths = [1, 2 * ps + 3, 5 * ps, 0, 3 * ps - 1]
    lengths += torch.randint(0, 3 * win if win else 5 * ps + 1, (lanes - 5,),
                             generator=gen).tolist()
    num_pages = n_slots * lanes + 1
    perm = torch.randperm(num_pages, generator=gen).tolist()
    tables = np.full((lanes, n_slots), num_pages, np.int32)
    for i, ln in enumerate(lengths):
        if ln:
            pages = (range(max(0, ln - win) // ps, (ln - 1) // ps + 2) if win
                     else range(-(-ln // ps)))
            for pg in pages:
                tables[i, pg % n_slots] = perm.pop()
    if win:
        tables[4, ((lengths[4] - 1) // ps + 2) % n_slots] = perm.pop()  # a stale id
        tables[0, ((lengths[0] - 1) // ps - 1) % n_slots] = num_pages  # unmapped, live range
    else:
        tables[4, 1] = num_pages  # an unmapped slot inside a live range
    t = torch.from_numpy(tables).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)

    def pages(shape):
        x = torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
        return _int8(x) if int8 else (x, None)

    if form == "mla":
        q, q2 = (torch.randn((lanes, 1, 16, w), generator=gen).to(dev) for w in (512, 64))
        (kp, ks), (k2p, k2s) = (pages((num_pages, ps, 1, w)) for w in (512, 64))
        args = (q, kp, None, t, lens)
        kw = dict(scale=576 ** -0.5, q2=q2, k2_pages=k2p, v_is_k=True, k_scale=ks, k2_scale=k2s)
        entry, dtype = "paged_attn_mla", torch.float32
    else:
        hkv, g, d = (1, 16, 256) if win else (12, 1, 64)
        q = torch.randn((lanes, hkv, g, d), generator=gen).to(torch.bfloat16).to(dev)
        (kp, ks), (vp, vs) = (pages((num_pages, ps, hkv, d)) for _ in range(2))
        args = (q, kp, vp, t, lens)
        kw = dict(scale=d ** -0.5, window=win, win_slots=n_slots if win else 0,
                  k_scale=ks, v_scale=vs)
        entry, dtype = ("paged_attn_win" if win else "paged_attn"), torch.bfloat16
    return args, kw, entry + ("_q" if int8 else ""), dtype, 2 if win else 3


def _launched(fn):
    """``fn()`` and the launch entries it counted (synchronized)."""
    before = dict(dispatch.launches)
    y = fn()
    torch.cuda.synchronize()
    after = dict(dispatch.launches)
    return y, {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("lanes", [5, 64])
@pytest.mark.parametrize("form", ["gqa", "window", "window_wide", "mla"])
def test_paged_attn_int8_kernel_matches_plain(dev, form, lanes):
    """K2q in each form over int8 pages (``_form_case``), 5 and 64 lanes.
    Counted under the form's int8 entry, none under the fp ones."""
    args, kw, entry, dtype, idle = _form_case(dev, form, lanes)
    y, counted = _launched(lambda: paged_attn(*args, **kw))
    assert counted == {entry: 1}
    ref = paged_attn_plain(*args, **kw)
    assert y.dtype == dtype
    torch.testing.assert_close(y.float(), ref.float(), **TOL[dtype])
    assert float(y[idle].abs().max()) == 0.0  # idle lane: exact zeros


@pytest.mark.parametrize("lanes", [5, 64])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("form", ["gqa", "window", "window_wide", "mla"])
def test_paged_attn_stats_kernel_matches_plain(dev, form, int8, lanes):
    """K3, the stats flush, in each form over bf16 and int8 pages: ``acc /
    l``, ``m`` and ``l`` against the plain stats in f32 (sums in another
    order), the idle lane exactly ``(0, -1e30, 0)``, counted under the
    form's ``_stats`` entry only."""
    args, kw, entry, _, idle = _form_case(dev, form, lanes, int8)
    (acc, m, l), counted = _launched(lambda: paged_attn(*args, emit_stats=True, **kw))
    stats = entry.replace("_q", "") + "_stats" + ("_q" if int8 else "")
    assert counted == {stats: 1}
    racc, rm, rl = paged_attn_stats_plain(*args, **kw)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    tol = TOL[torch.float32]
    torch.testing.assert_close(acc / l.clamp_min(1e-30)[..., None],
                               racc / rl.clamp_min(1e-30)[..., None], **tol)
    torch.testing.assert_close(m, rm, **tol)
    torch.testing.assert_close(l, rl, **tol)
    assert float(acc[idle].abs().max()) == 0.0 and float(l[idle].abs().max()) == 0.0
    assert bool((m[idle] == -1e30).all())


@pytest.mark.parametrize("lanes", [5, 140])
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("form", ["window_wide", "gqa", "mla"])
def test_paged_attn_window_kernel_is_deterministic(dev, form, int8, stats, lanes):
    """The same call twice gives the same bytes, in all four variants
    (fp and int8 pages, either flush) of the window form, split over
    several blocks a lane and merged (5 lanes) or walked by one block (140
    lanes): the combine sums the partials in a fixed order, with no
    atomics; and of the GQA and MLA forms, whose walk keeps one order."""
    args, kw, _, _, _ = _form_case(dev, form, lanes, int8)
    first, second = (paged_attn(*args, emit_stats=stats, **kw) for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second) if stats else [(first, second)]:
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("key", paged_attn_check.keys())
def test_paged_attn_bytes_equal_the_first_version(dev, key):
    """The GQA and MLA body (K2, K2m, K2q, K3) writes the first version's
    bytes: the SHA-256 of ``out`` (and ``m``, ``l`` under the stats flush)
    on each seeded case of ``kernels/paged_attn_check.py`` equals the
    digest taken from the first version's kernel, counted under the
    case's launch entry."""
    y, counted = _launched(lambda: paged_attn_check.run(paged_attn, key, dev))
    assert counted == {paged_attn_check.launch_entry(key): 1}
    assert paged_attn_check.digest(y) == paged_attn_check.DIGESTS[key]


def test_kernel_refuses_what_it_does_not_take(dev):
    vals, idx = _compressed(64, 32, 2, 4, 0, torch.float32, dev)
    x = torch.randn((2, 64), device=dev)
    with pytest.raises(TypeError):
        nm_spmm(x.bfloat16(), vals, idx, 2, 4)  # mixed types
    with pytest.raises(ValueError):
        nm_spmm(x, vals.t().contiguous().t(), idx, 2, 4)  # not contiguous
    with pytest.raises(ValueError):
        nm_spmm(x, vals.cpu(), idx, 2, 4)  # mixed devices
    v9, i9 = _compressed(72, 32, 2, 9, 0, torch.bfloat16, dev)
    with pytest.raises(ValueError):  # bf16 prefill: steps of lcm(9, 32) columns
        nm_spmm(torch.randn((16, 72), device=dev).bfloat16(), v9, i9, 2, 9)


def _bits(x):
    return x.float().cpu().view(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m", [(1, 4), (2, 4), (3, 4), (2, 8), (4, 8), (4, 16), (8, 32),
                                 (2, 6), (5, 12)])
@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 40), (2, 2, 192, 33)])
def test_nm_mask_kernel_matches_plain_bit_exact(dev, dtype, n, m, shape):
    """K4 against its plain version: the mask and the kept values exactly
    (the mask is integer-valued and kept values are copies); m of 6 and 12
    take the kernel's runtime-m path."""
    if shape[-2] % m:
        pytest.skip("rows are not whole groups")
    w = torch.randn(shape, generator=torch.Generator().manual_seed(n * 100 + m)).to(dtype)
    wd = w.to(dev)
    before = dispatch.launches["nm_mask"]
    masked, mask = nm_mask(wd, n, m)
    torch.cuda.synchronize()
    assert dispatch.launches["nm_mask"] == before + 1
    pmasked, pmask = nm_mask_plain(w, n, m)
    assert masked.dtype == mask.dtype == dtype and masked.shape == w.shape
    assert torch.equal(_bits(mask), _bits(pmask))
    assert torch.equal(_bits(masked), _bits(pmasked))
    per_group = mask.float().reshape(*shape[:-2], shape[-2] // m, m, shape[-1]).sum(-2)
    assert bool((per_group == n).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_mask_kernel_ties_zeros_and_n_equal_m(dev, dtype):
    """Equal magnitudes of both signs and all-zero groups keep the lowest
    rows, as the plain version's stable sort does; n == m launches
    nothing."""
    gen = torch.Generator().manual_seed(5)
    w = torch.tensor([-2.0, -1.0, 0.0, 1.0, 2.0])[torch.randint(0, 5, (128, 64), generator=gen)]
    w[:8] = 0.0
    w = w.to(dtype)
    for n, m in [(1, 4), (2, 4), (3, 8)]:
        masked, mask = nm_mask(w.to(dev), n, m)
        pmasked, pmask = nm_mask_plain(w, n, m)
        assert torch.equal(_bits(mask), _bits(pmask)) and torch.equal(_bits(masked), _bits(pmasked))
        assert mask[:m, 0].tolist() == [1.0] * n + [0.0] * (m - n)
    before = dispatch.launches["nm_mask"]
    masked, mask = nm_mask(w.to(dev), 4, 4)
    assert dispatch.launches["nm_mask"] == before
    assert bool((mask == 1).all()) and torch.equal(masked.cpu(), w)


def test_nm_mask_kernel_refuses_non_contiguous_and_wide_groups(dev):
    """A non-contiguous tensor raises (the recipes make a moved group axis
    contiguous before the call); so do m > 32 and other types."""
    w = torch.randn((64, 32), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        nm_mask(w.t(), 2, 4)
    with pytest.raises(ValueError):
        nm_mask(w, 2, 64)
    with pytest.raises(TypeError):
        nm_mask(w.half(), 2, 4)


# ---------------------------------------------------------------------------
# the device scheduler's decode loop: CUDA graph replay against the eager loop
# ---------------------------------------------------------------------------


def _serving_tree(arch, dev, **overrides):
    """``(cfg, compressed tree)`` of the reduced ``arch``, on the card."""
    from repro_torch import core
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import init_params
    from repro_torch.sparse_infer import export_compressed

    cfg = reduced(get_config(arch), **overrides)
    recipe = core.make_recipe("step", core.SparsityConfig(default=core.NMSparsity(2, 4)))
    return cfg, export_compressed(init_params(cfg, seed=0, device=dev), recipe)[0]


def _loop_engine(cfg, comp, dev, mode, prompts):
    """A device-scheduler engine (5 steps a dispatch, 2 staged lanes, two
    dispatches a cycle) on a paged pool, its loop ``mode`` given, the
    prompts submitted; every dispatch's outputs are kept as fetched."""
    from repro_torch.serving import DecodeEngine, SamplingParams

    eng = DecodeEngine(cfg, comp, max_batch=2, max_len=40, seed=0, num_pages=48, page_size=4,
                       device=dev, max_steps_per_dispatch=5, staged_lanes=2,
                       async_stream=True, device_loop=mode)
    fetch, eng.fetched = eng._fetch_block, []

    def keep(w):
        hb, steps, c_lane, c_step = fetch(w)
        eng.fetched.append((hb.copy(), steps, c_lane.copy(), c_step.copy()))
        return hb, steps, c_lane, c_step

    eng._fetch_block = keep
    for r, p in enumerate(prompts):
        eng.submit(p, SamplingParams(max_new_tokens=(9, 5, 12, 7, 6)[r % 5]))
    return eng


def _recurrent_leaves(cache):
    return {path: t for path, t in _tree_items(cache) if path.endswith(("state", "conv"))}


def _tree_items(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


@pytest.mark.parametrize("arch,overrides", [("gpt2-paper", {}),
                                            ("recurrentgemma-9b", {"n_layers": 8})])
def test_device_loop_graph_replay_equals_the_eager_loop(dev, arch, overrides):
    """The same traffic (refills from the staged ring, mid-loop freezes,
    gated iterations) through the captured graph and through the eager
    loop on the card, cycle by cycle: the same bytes of every dispatch's
    token block, steps and refill records, of ``cache["len"]`` and of the
    RG-LRU state, and the same streams; the replays count the eager
    loop's launches (and the capture its warm-up's)."""
    cfg, comp = _serving_tree(arch, dev, **overrides)
    prompts = [np.random.default_rng(7 + r).integers(0, cfg.vocab, 12 + 3 * r).tolist()
               for r in range(6)]
    engines, launches, results = {}, {}, {}
    for mode in ("graph", "eager"):
        engines[mode] = _loop_engine(cfg, comp, dev, mode, prompts)
        results[mode] = {}
    g, e = engines["graph"], engines["eager"]
    while g.queue or any(s is not None for s in g.slots):
        warm = g._loop.warmup_iterations
        for mode, eng in engines.items():
            dispatch.reset_launches()
            results[mode].update({r.uid: r.tokens for r in eng.step()})
            launches[mode] = dict(dispatch.launches)
        torch.cuda.synchronize()
        assert torch.equal(g.cache["len"], e.cache["len"])
        eager_rec = _recurrent_leaves(e.cache)
        for path, t in _recurrent_leaves(g.cache).items():
            assert torch.equal(t, eager_rec[path]), path
        # the replays count the eager loop's launches, and a capture adds its
        # warm-up iteration's
        per_replay = next(iter(g._loop.captured.values()), {})
        warmed = g._loop.warmup_iterations - warm
        assert launches["graph"] == {k: n + per_replay.get(k, 0) // 5 * warmed
                                     for k, n in launches["eager"].items()}
    assert not e.queue and not any(s is not None for s in e.slots)
    assert len(g.fetched) == len(e.fetched) == g.dispatches == 2 * g.cycles
    for a, b in zip(g.fetched, e.fetched):
        assert a[1] == b[1] and all(np.array_equal(x, y) for x, y in zip(a[::2], b[::2]))
        assert np.array_equal(a[3], b[3])
    assert results["graph"] == results["eager"]
    assert g.refills > 0 and g.stats()["gated_iterations"] > 0
    assert sum(g._loop.replays.values()) == g.dispatches
    assert g.stats()["device_loop"] == "graph" and e.stats()["device_loop"] == "eager"


def test_device_loop_capture_failure_raises(dev, monkeypatch):
    """A host sync inside the loop breaks its capture: the engine raises,
    and no eager loop runs in its place."""
    from repro_torch.serving import device_loop

    cfg, comp = _serving_tree("gpt2-paper", dev)
    real = device_loop.sample_tokens

    def syncing(logits, *args, **kw):
        logits.sum().item()  # a host read: not allowed while the stream is captured
        return real(logits, *args, **kw)

    monkeypatch.setattr(device_loop, "sample_tokens", syncing)
    eng = _loop_engine(cfg, comp, dev, "graph", [[1, 2, 3], [4, 5, 6, 7]])
    with pytest.raises(RuntimeError, match="capture of the decode loop"):
        eng.step()
    torch.cuda.synchronize()
    assert eng._loop.mode == "graph" and eng._loop.iterations == 0 and not eng.fetched
