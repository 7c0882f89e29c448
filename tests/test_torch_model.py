"""The port's gpt2-paper model held against the JAX package on the same
(carried-over) f32 weights: ``forward``, ``prefill`` and ``decode_step``
logits on the slab and the paged layout, for the dense and the compressed
tree.  Tolerance: ``torch_parity.LOGIT_TOL``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cache as jcache
from repro.models.model import TransformerLM
from repro_torch.models import model as tmodel
from repro_torch.models.cache import PagedLayout
from torch_parity import LOGIT_TOL, trees


@pytest.fixture(scope="module")
def setup():
    return trees()


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **LOGIT_TOL)


@pytest.mark.parametrize("kind", ["dense", "compressed"])
def test_forward_and_prefill_logits(setup, kind):
    jcfg, tcfg, t = setup
    jp, tp = t[kind]
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 11))
    jl, _, _ = TransformerLM(jcfg).forward(jp, {"tokens": jnp.asarray(toks)}, remat=False)
    tl, _ = tmodel.forward(tp, tcfg, torch.from_numpy(toks))
    _close(tl, jl)
    jl, _ = TransformerLM(jcfg).prefill(jp, {"tokens": jnp.asarray(toks)}, 16)
    tl, _ = tmodel.prefill(tp, tcfg, torch.from_numpy(toks), 16)
    _close(tl, jl)


@pytest.mark.parametrize("kind", ["dense", "compressed"])
@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_batched_prefill_then_decode_steps(setup, kind, layout):
    """Two ragged prompts padded into one prefill, written into lanes 1 and
    0, then four decode steps feeding the same tokens to both packages;
    the paged tables map scattered page ids."""
    jcfg, tcfg, t = setup
    jp, tp = t[kind]
    max_len, ps, num_pages = 16, 4, 10
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab, (2, 8))
    lens = np.array([5, 8], np.int32)
    lanes = np.array([1, 0], np.int32)
    feed = rng.integers(0, tcfg.vocab, (4, 2))
    table = np.array([[7, 2, 9, 10], [4, 0, 5, 10]], np.int32)  # 10 = sentinel
    jm = TransformerLM(jcfg)
    if layout == "paged":
        jlay = jcache.paged_layout_for(jcfg, max_len, page_size=ps, num_pages=num_pages)
        tlay = PagedLayout(page_size=ps, num_pages=num_pages, max_len=max_len)
    else:
        jlay, tlay = jcache.SlabLayout(max_len), None
    jc = jm.init_cache(2, max_len, layout=jlay)
    tc = tmodel.init_cache(tcfg, 2, max_len, layout=tlay, device="cpu")
    if layout == "paged":
        jc["tables"] = {"full": jnp.asarray(table)}
        tc["tables"]["full"].copy_(torch.from_numpy(table))
    jl, _, prod = jm.forward(jp, {"tokens": jnp.asarray(toks)}, remat=False, want_cache=True)
    jc = jm.write_prefill(jc, prod, jnp.asarray(lanes), jnp.asarray(lens), jlay)
    tl, tprod = tmodel.forward(tp, tcfg, torch.from_numpy(toks), want_cache=True)
    tmodel.write_prefill(tc, tcfg, tprod, torch.from_numpy(lanes).long(),
                         torch.from_numpy(lens), tlay)
    _close(tl, jl)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    for step in feed:
        jl, jc = jm.decode_step(jp, jnp.asarray(step, jnp.int32), jc, jlay)
        tl, tc = tmodel.decode_step(tp, tcfg, torch.from_numpy(step).int(), tc, tlay)
        _close(tl, jl)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
