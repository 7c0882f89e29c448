"""The port's ``paged_attn`` (its plain version, which CPU tensors take)
held against the JAX Pallas kernel in interpret mode, on the ragged lanes,
sentinel slots and idle lane of ``tests/test_paged_attn.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn import paged_attn_pallas
from repro_torch.kernels.paged_attn import paged_attn
from repro_torch.models.layers import decode_attention

# f32 on both sides: page-by-page online softmax vs one gathered softmax
TOL = dict(atol=1e-5, rtol=1e-5)


def _full_tables(lengths, ps, n_slots, num_pages):
    """Append-only tables: distinct pages for every lane's live prefix."""
    t = np.full((len(lengths), n_slots), num_pages, np.int32)
    nxt = 0
    for i, ln in enumerate(lengths):
        for pg in range(-(-ln // ps)):
            t[i, pg] = nxt % num_pages
            nxt += 1
    return t


@pytest.mark.parametrize("hkv,g", [(4, 1), (2, 3)])  # MHA, GQA
def test_plain_matches_pallas_interpret(hkv, g):
    b, d, ps, num_pages, n_slots = 4, 16, 4, 12, 6
    lengths = [1, 7, 21, 0]  # partial page / multi-page / near-cap / idle
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    tables = _full_tables(lengths, ps, n_slots, num_pages)
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


def test_unported_options_are_refused():
    q = torch.zeros((1, 1, 1, 4))
    pages = torch.zeros((2, 4, 1, 4))
    with pytest.raises(TypeError):
        paged_attn(q, pages, pages, torch.zeros((1, 1), dtype=torch.int32),
                   torch.ones(1, dtype=torch.int32), scale=0.5, window=4)
