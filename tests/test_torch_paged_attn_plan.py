"""The launch plan of ``paged_attn``'s GQA/MLA kernel, a pure function of the
shapes and the SM count (``attn_plan``), with the shared memory it takes
(``attn_smem_bytes``).  No card needed: on the card the wrapper passes the
plan to ``csrc/paged_attn.cu`` unchanged."""
import itertools

import pytest

from repro_torch.kernels.paged_attn import (
    ATTN_ITEMS,
    ATTN_MAX_PAGES,
    ATTN_MAX_PS,
    ATTN_MAX_STAGES,
    ATTN_MAX_THREADS,
    ATTN_MIN_WARPS,
    ATTN_RING_PAGES,
    ATTN_WARP_ROW_MIN,
    SMEM_MAX,
    AttnPlan,
    attn_plan,
    attn_smem_bytes,
)

GPT2 = dict(hkv=12, g=1, d=64, d2=0, dv=64, mla=False)  # 12 heads of 64, one a KV head
DEEPSEEK = dict(hkv=1, g=16, d=512, d2=64, dv=512, mla=True)  # latent 512 + RoPE 64


def _plan(b, shape, ps=16, itemsize=2, quant=False, sms=132):
    return attn_plan(b, shape["hkv"], shape["g"], shape["d"], shape["d2"], shape["dv"], ps,
                     itemsize, quant, shape["mla"], sms)


@pytest.mark.parametrize("b,shape,itemsize,quant,sms,plan", [
    # phase 2's GQA shape and gpt2's decode (4 lanes): one head a block, 8
    # pages of 16 rows a stage, so each of the 128 threads scores a row
    (4, GPT2, 2, False, 132, (1, 128, 8, 2)),
    (4, GPT2, 1, True, 132, (1, 128, 8, 2)),
    (4, GPT2, 2, False, 1, (1, 128, 8, 2)),
    # phase 2's MLA shape and DeepSeek's decode (4 lanes): 64 blocks of one
    # head; 8 warps score 4 rows each, so a stage is two pages, 4 in the ring
    (4, DEEPSEEK, 2, False, 132, (1, 256, 2, 2)),
    (4, DEEPSEEK, 1, True, 132, (1, 256, 2, 2)),
    (4, DEEPSEEK, 4, False, 132, (1, 256, 2, 2)),
    (8, DEEPSEEK, 2, False, 132, (1, 256, 2, 2)),  # 128 blocks: still one wave
    (16, DEEPSEEK, 2, False, 132, (2, 256, 1, 4)),  # 2 heads a block: 128 blocks
    (64, DEEPSEEK, 4, False, 132, (8, 256, 1, 4)),  # the card test's 64 lanes
    # one SM: every head of a KV head in one block
    (4, DEEPSEEK, 2, False, 1, (16, 512, 1, 4)),
    (64, DEEPSEEK, 1, True, 1, (16, 512, 1, 4)),
])
def test_attn_plan_at_the_main_paths_shapes(b, shape, itemsize, quant, sms, plan):
    assert _plan(b, shape, itemsize=itemsize, quant=quant, sms=sms) == AttnPlan(*plan)


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("itemsize,quant", [(4, False), (2, False), (1, True)])
def test_attn_plan_over_a_grid_of_shapes(sms, itemsize, quant):
    """Over lanes, heads, widths and page sizes: the heads a block divide
    G, and are the fewest that keep the grid within one wave of ``sms``
    (or all of G where none does); enough warps for the items, at least
    ATTN_MIN_WARPS; 1 to ATTN_MAX_PAGES pages a stage, 2 to ATTN_MAX_STAGES stages, or
    one where two stages of one page do not fit; the shared memory within
    SMEM_MAX.  (A page of 128 rows of 256 f32 values of K and V overflows
    it, as it did the first version's.)"""
    for b, hkv, g, (d, d2, mla), ps in itertools.product(
            (1, 4, 9, 64), (1, 2, 12), (1, 3, 4, 16),
            ((16, 0, False), (64, 0, False), (256, 0, False), (16, 8, True),
             (512, 64, True)), (2, 4, 16, 32, 64)):
        dv = d
        plan = attn_plan(b, hkv, g, d, d2, dv, ps, itemsize, quant, mla, sms)
        slices = -(-dv // (32 * (4 if mla else 2)))
        assert g % plan.heads == 0
        assert plan.heads * slices <= plan.threads // 32 * ATTN_ITEMS
        fewest = ATTN_MIN_WARPS[d + d2 >= ATTN_WARP_ROW_MIN]
        assert plan.threads % 32 == 0 and 32 * fewest <= plan.threads <= ATTN_MAX_THREADS
        if plan.threads > 32 * fewest:  # no more warps than the items need
            assert plan.threads // 32 == -(-plan.heads * slices // ATTN_ITEMS)
        fewer = [h for h in range(1, plan.heads) if g % h == 0]
        if b * hkv * (g // plan.heads) <= sms:
            assert all(b * hkv * (g // h) > sms for h in fewer)
        else:
            assert plan.heads == g
        assert 1 <= plan.pages <= ATTN_MAX_PAGES
        assert 1 <= plan.stages <= ATTN_MAX_STAGES
        if plan.stages == 1:  # only where two stages of one page do not fit
            assert plan.pages == 1 and attn_smem_bytes(
                plan.heads, plan.threads, d, d2, dv, ps, itemsize, quant, mla, 1, 2) > SMEM_MAX
        assert plan.stages <= 2 or plan.pages * (plan.stages - 1) < ATTN_RING_PAGES
        assert attn_smem_bytes(plan.heads, plan.threads, d, d2, dv, ps, itemsize, quant, mla,
                               plan.pages, plan.stages) <= SMEM_MAX
        assert plan.pages == 1 or ps <= 32  # a page of more rows is a stage alone


def test_attn_smem_bytes_by_hand():
    """gpt2's plan (bf16): 64 f32 query values, 128 scores, 2 x 9 page
    records, 4 warps x (128 probabilities + 8 rescales), then two stages of
    8 pages x 16 rows of K and V, each row of 128 bytes padded to 144;
    DeepSeek's int8 plan: 576 query values, 32 scores, 2 x 3 records, 8
    warps x (32 + 8), two stages of two pages of 16 latent rows (512 B
    padded to 528), RoPE rows (64 B to 80) and two 64-byte scale planes."""
    assert attn_smem_bytes(1, 128, 64, 0, 64, 16, 2, False, False, 8, 2) == (
        (64 + 128 + 18 + 4 * 136) * 4 + 8 + 2 * (128 * 144 * 2))  # + 8: aligned to 16
    assert attn_smem_bytes(1, 256, 512, 64, 512, 16, 1, True, True, 2, 2) == (
        (576 + 32 + 6 + 8 * 40) * 4 + 8 + 2 * (32 * 528 + 32 * 80 + 2 * 64))


def test_attn_plan_refuses_what_the_kernel_does_not_take():
    """ps over ATTN_MAX_PS, a Dv beyond 16 warps of items, and a page of
    one head that overflows the shared memory; rows that are not whole
    4-byte words (bf16 D = 3, int8 D2 = 6), a Dv that is no multiple of a
    lane's output columns and int8 pages of an odd ps are taken."""
    with pytest.raises(ValueError, match="at most 256 rows"):
        attn_plan(4, 1, 1, 64, 0, 64, ATTN_MAX_PS + 1, 2, False, False, 132)
    assert attn_plan(4, 1, 1, 64, 0, 64, ATTN_MAX_PS, 2, False, False, 132) == AttnPlan(
        1, 128, 1, 3)
    with pytest.raises(ValueError, match="wider"):
        attn_plan(1, 1, 1, 64, 0, 64 * 64 + 2, 16, 4, False, False, 132)
    assert attn_plan(1, 1, 1, 256, 0, 256, 64, 4, False, False, 132) == AttnPlan(1, 256, 1, 1)
    with pytest.raises(ValueError, match="shared memory"):
        attn_plan(1, 1, 1, 256, 0, 256, 128, 4, False, False, 132)
    assert attn_plan(4, 1, 1, 3, 0, 3, 16, 2, False, False, 132) == AttnPlan(1, 128, 8, 2)
    assert attn_plan(4, 1, 4, 16, 6, 16, 16, 1, True, True, 132) == AttnPlan(1, 128, 8, 2)
    assert attn_plan(4, 1, 1, 64, 0, 63, 16, 4, False, False, 132) == AttnPlan(1, 128, 8, 2)
    assert attn_plan(4, 1, 4, 18, 8, 18, 16, 2, False, True, 132) == AttnPlan(1, 128, 8, 2)
    assert attn_plan(4, 1, 1, 64, 0, 64, 5, 1, True, False, 132) == AttnPlan(1, 128, 8, 2)


def _first_version_took(b, hkv, g, d, d2, dv, ps, mla):
    """Whether the first version's kernel (064ba4a) launched the shape: its
    heads a block (G halved while even and the grid under 64 blocks) and
    f32 staging of one page had to fit the block's shared memory."""
    gb = g
    while gb > 2 and gb % 2 == 0 and b * hkv * (g // gb) < 64:
        gb //= 2
    floats = (gb * (d + d2) + ps * (d + 1) + ps * (d2 + 1) + (0 if mla else ps * dv)
              + gb * ps + gb * dv + 3 * gb)
    return 4 * floats <= SMEM_MAX


@pytest.mark.parametrize("mla", [False, True])
@pytest.mark.parametrize("itemsize,quant", [(4, False), (2, False), (1, True)])
def test_attn_plan_takes_every_shape_the_first_version_took(mla, itemsize, quant):
    """Every shape the first version launched with pages of up to
    ATTN_MAX_PS rows has a plan, odd widths and page sizes and pages that
    fill the shared memory included (the fallback to fewer heads a
    block); only pages of more rows are refused."""
    took = 0
    for b, g, d, ps in itertools.product(
            (1, 4, 64), (1, 3, 16, 32), (1, 3, 5, 16, 31, 64, 100, 256, 512),
            (1, 2, 3, 7, 16, 33, 64, 96, 100, 128, 200, 224, 256, 300)):
        for d2, dv in ((8, d), (64, d)) if mla else ((0, d), (0, d + 1)):
            if not _first_version_took(b, 1, g, d, d2, dv, ps, mla):
                continue
            took += 1
            if ps > ATTN_MAX_PS:
                with pytest.raises(ValueError, match="at most"):
                    attn_plan(b, 1, g, d, d2, dv, ps, itemsize, quant, mla, 132)
                continue
            plan = attn_plan(b, 1, g, d, d2, dv, ps, itemsize, quant, mla, 132)
            assert attn_smem_bytes(plan.heads, plan.threads, d, d2, dv, ps, itemsize, quant,
                                   mla, plan.pages, plan.stages) <= SMEM_MAX
    assert took > 500
