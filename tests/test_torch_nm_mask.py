"""The port's ``nm_mask`` (K4) on CPU tensors, i.e. its plain version, held
bit-exact against the JAX Pallas kernel in interpret mode and against the
JAX mask math: the mask is integer-valued and the kept values are copies,
so no tolerance applies.  Also: ``n == m`` launches nothing, stacked 3-D
leaves equal per-slice calls, ties break to the lower index, and the
Decaying-Mask recipe's traced ``n`` (``nm_mask_dynamic``) matches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masking as jmask
from repro.kernels.nm_mask import nm_mask_apply_pallas
from repro_torch.core import masking as tmask
from repro_torch.kernels import dispatch
from repro_torch.kernels.nm_mask import nm_mask, nm_mask_plain

# the NM list, types and shapes of tests/test_kernels.py
NM = [(1, 4), (2, 4), (2, 8), (4, 8), (4, 16), (8, 32)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
SHAPES = [(64, 48), (128, 128), (512, 300), (96, 64)]


def _bits(x):
    """Exact comparison key: the f32 bit pattern (bf16 widens exactly), so
    +0.0 and -0.0 differ."""
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, np.float32).view(np.int32)


def _pair(w_np, jdt, tdt):
    return jnp.asarray(w_np, jdt), torch.from_numpy(np.array(w_np)).to(tdt)


def _tied(shape, seed=0):
    """Few magnitudes, both signs, and some all-zero groups of 4."""
    rng = np.random.default_rng(seed)
    w = rng.choice([-2.0, -1.0, 0.0, 1.0, 2.0], size=shape).astype(np.float32)
    w[:4, ::3] = 0.0
    return w


@pytest.mark.parametrize("n,m", NM)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_kernel_bit_exact(n, m, jdt, tdt, shape):
    w_np = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32))
    wj, wt = _pair(w_np, jdt, tdt)
    before = dict(dispatch.launches)
    masked, mask = nm_mask(wt, n, m)
    assert dispatch.launches == before  # the plain version counts no launch
    jmasked, jmask_ = nm_mask_apply_pallas(wj, n, m, interpret=True)
    assert mask.dtype == tdt and masked.dtype == tdt
    np.testing.assert_array_equal(_bits(mask), _bits(jmask_))
    np.testing.assert_array_equal(_bits(masked), _bits(jmasked))  # +0.0 where pruned
    assert (mask.float().reshape(-1, m, shape[1]).sum(1) == n).all()


@pytest.mark.parametrize("n,m", [(1, 4), (2, 4), (2, 8)])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_ties_and_zero_groups_keep_the_lowest_index(n, m, jdt, tdt):
    w_np = _tied((64, 24))
    wj, wt = _pair(w_np, jdt, tdt)
    masked, mask = nm_mask(wt, n, m)
    jmasked, jmask_ = nm_mask_apply_pallas(wj, n, m, interpret=True)
    np.testing.assert_array_equal(_bits(mask), _bits(jmask_))
    np.testing.assert_array_equal(_bits(masked), _bits(jmasked))
    np.testing.assert_array_equal(_bits(mask), _bits(jmask.nm_mask(wj, n, m, 0)))
    if m == 4:  # an all-zero group keeps its first n rows
        assert mask[:4, 0].tolist() == [1.0] * n + [0.0] * (4 - n)


def test_stacked_leaf_equals_per_slice_calls():
    w_np = np.random.default_rng(1).standard_normal((3, 32, 16)).astype(np.float32)
    masked, mask = nm_mask(torch.from_numpy(w_np), 2, 4)
    for i in range(3):
        jmasked, jmask_ = nm_mask_apply_pallas(jnp.asarray(w_np[i]), 2, 4, interpret=True)
        np.testing.assert_array_equal(_bits(mask[i]), _bits(jmask_))
        np.testing.assert_array_equal(_bits(masked[i]), _bits(jmasked))
    np.testing.assert_array_equal(
        _bits(mask), _bits(jmask.nm_mask(jnp.asarray(w_np), 2, 4, -2)))


@pytest.mark.parametrize("m", [4, 8])
def test_dynamic_n_matches_traced_n(m):
    """The Decaying-Mask recipe's n at every value its schedule takes."""
    w_np = _tied((32, 12), seed=3)
    wj, wt = jnp.asarray(w_np), torch.from_numpy(w_np)
    for n in range(1, m + 1):
        ref = _bits(jmask.nm_mask_dynamic(wj, jnp.int32(n), m, 0))
        np.testing.assert_array_equal(_bits(tmask.nm_mask_dynamic(wt, n, m, 0)), ref)
        np.testing.assert_array_equal(_bits(nm_mask(wt, n, m)[1]), ref)


def test_n_equal_m_keeps_everything_and_raises_on_bad_groups():
    w = torch.randn(8, 5)
    masked, mask = nm_mask(w, 4, 4)
    assert torch.equal(mask, torch.ones_like(w)) and torch.equal(masked, w)
    assert masked.data_ptr() != w.data_ptr()
    with pytest.raises(ValueError):
        nm_mask(torch.randn(6, 5), 2, 4)  # 6 rows are not whole groups of 4
    with pytest.raises(ValueError):
        nm_mask_plain(torch.randn(8), 2, 4)  # needs (..., R, C)
