"""N:M mask math, compression and export of the PyTorch port, held bit-exact
against the JAX package (integer outputs and selected values: exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import masking as jmask
from repro.sparse_infer import compression_report as jax_report
from repro_torch import core as tcore
from repro_torch.checkpoint import carry_over
from repro_torch.core import masking as tmask
from repro_torch.sparse_infer import (
    CompressedTensor,
    compress_params,
    compression_report,
    decompress_params,
)
from repro_torch.utils.tree import tree_items
from torch_parity import to_numpy, trees

NM = [(1, 4), (2, 4), (2, 8), (4, 8)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _weights(shape, tied: bool, seed=0):
    rng = np.random.default_rng(seed)
    if tied:  # few distinct magnitudes, both signs: ties in most groups
        return rng.choice([-2.0, -1.0, 1.0, 2.0, 3.0], size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _bits(x):
    """Exact comparison key: bf16/f32 bit patterns as integers."""
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("n,m", NM)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("shape,axis", [((64, 24), 0), ((3, 32, 16), -2), ((16, 40), 1)])
def test_mask_compress_decompress_bit_exact(n, m, jdt, tdt, tied, shape, axis):
    if shape[axis] % m:
        pytest.skip("group axis not divisible by m")
    w_np = _weights(shape, tied)
    wj = jnp.asarray(w_np, jdt)
    wt = torch.from_numpy(w_np).to(tdt)
    np.testing.assert_array_equal(
        _bits(tmask.nm_mask(wt, n, m, axis)), _bits(jmask.nm_mask(wj, n, m, axis)))
    vj, ij = jmask.nm_compress(wj, n, m, axis)
    vt, it = tmask.nm_compress(wt, n, m, axis)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(_bits(vt), _bits(vj))
    np.testing.assert_array_equal(
        _bits(tmask.nm_decompress(vt, it, n, m, axis)),
        _bits(jmask.nm_decompress(vj, ij, n, m, axis)))


def test_ties_break_toward_lower_index():
    """The case torch.topk gets wrong: [1,3,3,3] keeps offsets 1 and 2."""
    w = torch.tensor([[1.0], [3.0], [3.0], [3.0]])
    _, idx = tmask.nm_compress(w, 2, 4)
    assert idx[:, 0].tolist() == [1, 2]
    assert tmask.nm_mask(w, 2, 4)[:, 0].tolist() == [0.0, 1.0, 1.0, 0.0]


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_export_and_compress_params_bit_exact(jdt, tdt):
    """Recipe export (Π_T ⊙ w) and compress_params on the whole reduced
    gpt2-paper tree equal the JAX artifact leaf for leaf.  The port's export
    is the ``nm_mask`` kernel's ``where(Π, w, 0)`` (+0.0 where pruned, as the
    Pallas kernel writes it), so it is held against the same select on JAX's
    Π_T; the reference's ``p * mask`` differs from it only in signed zeros."""
    import jax

    from repro.configs import get_config
    from repro.models.model import TransformerLM
    from repro.sparse_infer import compress_params as jax_compress

    cfg = get_config("gpt2-paper", smoke=True)
    params = jax.tree_util.tree_map(
        lambda x: x.astype(jdt), TransformerLM(cfg).init(jax.random.PRNGKey(0)))
    jrec = jcore.make_recipe("step", jcore.SparsityConfig(default=jcore.NMSparsity(2, 4)))
    trec = tcore.make_recipe("step", tcore.SparsityConfig(default=tcore.NMSparsity(2, 4)))
    jsparse = jax.tree_util.tree_map(lambda p, mk: jnp.where(mk != 0, p, jnp.zeros_like(p)),
                                     params, jrec.final_masks(params))
    tsparse = trec.export_sparse(carry_over(to_numpy(params), device="cpu"))
    jcomp = jax_compress(jsparse, jrec.sparsity)
    tcomp = compress_params(tsparse, trec.sparsity)
    jflat, tflat = dict(tree_items(to_numpy(jsparse))), dict(tree_items(tsparse))
    assert jflat.keys() == tflat.keys()
    for k, leaf in jflat.items():
        np.testing.assert_array_equal(_bits(tflat[k]), _bits(leaf), err_msg=k)
    jflat, tflat = dict(tree_items(to_numpy(jcomp))), dict(tree_items(tcomp))
    assert jflat.keys() == tflat.keys()
    for k, jleaf in jflat.items():
        tleaf = tflat[k]
        if not isinstance(jleaf, tuple):
            assert not isinstance(tleaf, CompressedTensor), k
            np.testing.assert_array_equal(_bits(tleaf), _bits(jleaf), err_msg=k)
            continue
        assert (tleaf.n, tleaf.m, tleaf.group_axis, tleaf.shape, tleaf.pad) == (
            jleaf[2], jleaf[3], jleaf[4], tuple(jleaf[5]), jleaf[6]), k
        np.testing.assert_array_equal(tleaf.indices.numpy(), jleaf[1], err_msg=k)
        np.testing.assert_array_equal(_bits(tleaf.values), _bits(jleaf[0]), err_msg=k)
    assert compression_report(tsparse, tcomp) == jax_report(jsparse, jcomp)


def test_padded_artifact_decompresses_to_true_width():
    """A JAX export with alignment padding (``pad > 0``) decompresses to
    the unpadded dense weight."""
    _, _, t = trees(align=128)
    jcomp, tcomp = t["compressed"]
    leaf = tcomp["body"]["sb_0"]["attn"]["wq"]
    assert leaf.pad > 0 and leaf.out_features == leaf.shape[-1]
    dense = decompress_params(tcomp)["body"]["sb_0"]["attn"]["wq"]
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(jcomp["body"]["sb_0"]["attn"]["wq"].dense()))
