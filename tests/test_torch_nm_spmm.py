"""The port's ``nm_spmm`` (its plain version, which CPU tensors take) held
against the JAX Pallas kernel run in interpret mode, in both regimes of the
plain version (B <= 8 gathers, B > 8 decompresses), with and without
alignment padding; and its expert-batched form against the JAX ``vmap`` of
the kernel that the reference's stacked matmul runs.  Also the CUDA
launch's plan, a plain function of the shapes (``decode_cols``,
``prefill_plan``, ``launch_plan``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.masking import nm_compress as jax_compress
from repro.kernels.nm_spmm import nm_spmm_pallas
from repro_torch.kernels import dispatch
from repro_torch.kernels.nm_spmm import (
    DECODE_ROWS,
    FIRST_BODY,
    MIN_WIDE_BLOCKS,
    SMEM_MAX,
    TC_EXPERTS,
    TC_KCHUNK,
    TC_SMALL,
    X_SMEM_BYTES,
    PrefillPlan,
    decode_cols,
    launch_plan,
    nm_spmm,
    nm_spmm_batched,
    nm_spmm_plain,
    prefill_plan,
    prefill_smem_bytes,
)
from repro_torch.models.layers import matmul
from repro_torch.sparse_infer import CompressedTensor

# f32 on both sides; the two sum the same products in different orders
TOL = dict(atol=1e-5, rtol=1e-5)


def _case(b, k, o, n, m, pad, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, k)).astype(np.float32)
    w = rng.standard_normal((k, o)).astype(np.float32)
    v, i = (np.array(a) for a in jax_compress(jnp.asarray(w), n, m, 0))
    if pad:  # alignment columns appended at compress time, as compress_params(align=) does
        v = np.pad(v, ((0, 0), (0, pad)))
        i = np.pad(i, ((0, 0), (0, pad)))
    return x, v, i


@pytest.mark.parametrize("b", [1, 5, 8, 16, 20])
@pytest.mark.parametrize("n,m", [(2, 4), (1, 4), (2, 8)])
@pytest.mark.parametrize("pad", [0, 24])
def test_plain_matches_pallas_interpret(b, n, m, pad):
    k, o = 64, 40
    x, v, i = _case(b, k, o, n, m, pad)
    y_ref = nm_spmm_pallas(jnp.asarray(x), jnp.asarray(v), jnp.asarray(i), n, m,
                           bm=8, bo=32, bk=32, o_true=o, interpret=True)
    y = nm_spmm(torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(i), n, m,
                o_true=o)
    assert y.shape == (b, o) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)


def test_cpu_tensors_take_the_plain_version_uncounted():
    x, v, i = _case(4, 32, 16, 2, 4, 0)
    dispatch.reset_launches()
    xt, vt, it = torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(i)
    assert torch.equal(nm_spmm(xt, vt, it, 2, 4), nm_spmm_plain(xt, vt, it, 2, 4))
    assert dispatch.launches == dict.fromkeys(dispatch.KERNELS, 0)


def test_compressed_matmul_equals_dense_matmul_on_masked_weight():
    """layers.matmul on a CompressedTensor: 3-D activations, bf16 output."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((32, 24)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 7, 32)).astype(np.float32))
    v, i = (torch.from_numpy(np.array(a)) for a in jax_compress(jnp.asarray(w.numpy()), 2, 4, 0))
    ct = CompressedTensor(v, i, 2, 4, 0, (32, 24))
    np.testing.assert_allclose(matmul(x, ct).numpy(), (x @ ct.dense()).numpy(), **TOL)
    y16 = matmul(x.bfloat16(), CompressedTensor(v.bfloat16(), i, 2, 4, 0, (32, 24)))
    assert y16.dtype == torch.bfloat16 and y16.shape == (2, 7, 24)


def test_rejects_groups_that_do_not_tile_k():
    x, v, i = _case(2, 32, 16, 2, 4, 0)
    with pytest.raises(ValueError):
        nm_spmm(torch.from_numpy(x[:, :30]), torch.from_numpy(v), torch.from_numpy(i), 2, 4)


@pytest.mark.parametrize("b", [1, 8, 20])
def test_batched_plain_matches_vmapped_pallas_interpret(b):
    """Three experts of (64 -> 40) at 2:4 with 24 alignment columns, as
    ``layers.matmul`` vmaps the reference kernel over a compressed stack."""
    e, k, o, pad = 3, 64, 40, 24
    cases = [_case(b, k, o, 2, 4, pad, seed=s) for s in range(e)]
    x, v, i = (np.stack(parts) for parts in zip(*cases))
    y_ref = jax.vmap(lambda xe, ve, ie: nm_spmm_pallas(
        xe, ve, ie, 2, 4, bm=8, bo=32, bk=32, o_true=o, interpret=True))(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(i))
    y = nm_spmm_batched(torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(i), 2, 4,
                        o_true=o)
    assert y.shape == (e, b, o)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    ct = CompressedTensor(torch.from_numpy(v), torch.from_numpy(i), 2, 4, -2, (e, k, o + pad),
                          pad=pad)
    assert torch.equal(matmul(torch.from_numpy(x), ct), y)  # the stacked matmul takes it


@pytest.mark.parametrize("b,k,o,e,itemsize,aligned,cols", [
    (4, 768, 768, 1, 2, True, 1),  # gpt2-paper q/k/v/o: few columns, 1 a lane
    (4, 3072, 768, 1, 2, True, 1),  # gpt2-paper proj
    (4, 4096, 12288, 1, 2, True, 4),  # RecurrentGemma-9B w_up: 96 blocks of 128 columns
    (4, 12288, 4096, 1, 2, True, 1),  # RecurrentGemma-9B w_down: x fills 96 KB at B = 4
    (8, 12288, 4096, 1, 2, True, 0),  # ... and overflows it at B = 8
    (8, 2048, 1408, 64, 2, True, 4),  # DeepSeek-V2-Lite experts, C = 8
    (8, 1408, 2048, 64, 2, True, 4),
    (4, 2048, 10944, 1, 2, True, 4), (4, 2048, 10944, 1, 2, False, 1),  # alignment
    (4, 512, 10242, 1, 2, True, 1),  # O not a multiple of 4
    (9, 64, 40, 1, 2, True, 0), (256, 768, 768, 1, 2, True, 0),  # prefill
    (1, 6144, 4096, 1, 4, True, 1), (5, 6144, 4096, 1, 4, True, 0),  # f32 staging
])
def test_decode_plan_from_shapes(b, k, o, e, itemsize, aligned, cols):
    assert decode_cols(b, k, o, o, e, itemsize, aligned) == cols


def test_decode_plan_edges():
    """4 columns a lane exactly from MIN_WIDE_BLOCKS blocks of 128 on; the
    decode kernel up to DECODE_ROWS rows and X_SMEM_BYTES of staged x."""
    o = 128 * MIN_WIDE_BLOCKS
    assert decode_cols(4, 64, o, o, 1, 2, True) == 4
    assert decode_cols(4, 64, o - 128, o - 128, 1, 2, True) == 1
    assert decode_cols(4, 64, o // 2, o // 2, 2, 2, True) == 4  # the experts count too
    k = X_SMEM_BYTES // (DECODE_ROWS * 2)
    assert decode_cols(DECODE_ROWS, k, 64, 64, 1, 2, True) == 1
    assert decode_cols(DECODE_ROWS, k + 4, 64, 64, 1, 2, True) == 0
    assert decode_cols(DECODE_ROWS + 1, 64, 64, 64, 1, 2, True) == 0


@pytest.mark.parametrize("k,o,e,n,m,plan", [
    (768, 768, 1, 2, 4, (*TC_SMALL, 64)),  # gpt2-paper q/k/v/o, fc, proj
    (768, 3072, 1, 2, 4, (*TC_SMALL, 64)), (3072, 768, 1, 2, 4, (*TC_SMALL, 64)),
    (4096, 12288, 1, 2, 4, (*TC_SMALL, 64)),  # RecurrentGemma-9B's MLP and projections
    (12288, 4096, 1, 2, 4, (*TC_SMALL, 64)), (4096, 4096, 1, 2, 4, (*TC_SMALL, 64)),
    (2048, 10944, 1, 2, 4, (*TC_SMALL, 64)),  # DeepSeek-V2-Lite's dense first MLP
    (2048, 1408, 64, 2, 4, (*TC_EXPERTS, 64)), (1408, 2048, 64, 2, 4, (*TC_EXPERTS, 64)),
    (512, 96, 1, 1, 4, (*TC_SMALL, 64)), (512, 96, 3, 2, 8, (*TC_EXPERTS, 64)),
    (320, 64, 1, 16, 64, (*TC_SMALL, 64)), (384, 64, 1, 1, 128, (*TC_SMALL, 128)),
    (192, 48, 1, 6, 12, (*TC_SMALL, 96)),  # steps of lcm(12, 32) columns
    (4096, 12288, 1, 256, 256, (*TC_SMALL, 256)),
    (8192, 1408, 64, 256, 256, (*TC_SMALL, 256)),  # the experts' tile does not fit: 64 x 64
])
def test_prefill_plan_from_shapes(k, o, e, n, m, plan):
    got = prefill_plan(k, o, e, n, m, 2)
    assert got == PrefillPlan(*plan)
    assert got.depth % m == 0 and got.depth % TC_KCHUNK == 0
    assert prefill_smem_bytes(got, n, m) <= SMEM_MAX


def test_prefill_plan_ignores_b():
    """The rows of a call never reach the plan: one weight gets one plan
    at every B past DECODE_ROWS (bf16), the decode kernel's columns at or
    under it, and f32 keeps the first version's body at every B."""
    for k, o, e in ((768, 3072, 1), (4096, 12288, 1), (2048, 1408, 64)):
        plans = {launch_plan(b, k, o, o, e, 2, 4, 2, True)
                 for b in range(DECODE_ROWS + 1, 2200, 37)}
        assert plans == {(0, prefill_plan(k, o, e, 2, 4, 2))}
        for b in range(1, DECODE_ROWS + 1):
            assert launch_plan(b, k, o, o, e, 2, 4, 2, True) == (
                decode_cols(b, k, o, o, e, 2, True), FIRST_BODY)
        assert {launch_plan(b, k, o, o, e, 2, 4, 4, True)[1] for b in (9, 256, 2048)} == {
            FIRST_BODY}


@pytest.mark.parametrize("n,m,itemsize", [
    (2, 4, 4),  # f32: the first version's body
    (2, 9, 2), (1, 17, 2), (3, 100, 2),  # steps of lcm(m, 32) > 256 columns
    (5, 4, 2), (0, 4, 2), (2, 512, 2),  # n:m outside 1 <= n <= m <= 256
])
def test_prefill_plan_refuses_what_the_body_does_not_take(n, m, itemsize):
    with pytest.raises(ValueError):
        prefill_plan(m * 64, 128, 1, n, m, itemsize)


def test_every_prefill_plan_fits_shared_memory():
    for m in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256):
        for n in sorted({1, min(2, m), max(1, m // 2), m}):
            for k, o, e in ((m * 256, 12288, 1), (m * 4, 64, 1), (m * 8, 1408, 64)):
                plan = prefill_plan(k, o, e, n, m, 2)
                assert prefill_smem_bytes(plan, n, m) <= SMEM_MAX, (n, m, plan)
