"""The port's ``moe_mlp`` held against the reference's on the same f32
weights and tokens, with a capacity small enough that pairs are dropped:
the same experts picked (two router columns are equal, so the top-k
tie order is exercised), the same pairs kept per expert, outputs and the
aux loss within ``torch_parity.LOGIT_TOL``; dense and compressed experts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.models import moe as jmoe
from repro.sparse_infer import compress_params as jax_compress_params
from repro_torch.checkpoint import carry_over
from repro_torch.models import moe as tmoe
from torch_parity import LOGIT_TOL, configs, to_numpy

T = 64  # tokens: (2, 32)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs("deepseek-v2-lite-16b")
    jm = dataclasses.replace(jcfg.moe, capacity_factor=1.0)
    tm = dataclasses.replace(tcfg.moe, capacity_factor=1.0)
    p = jmoe.init_moe_params(jax.random.PRNGKey(1), jcfg.d_model, jm, jnp.float32)
    p["router"] = p["router"].at[:, 3].set(p["router"][:, 1])  # experts 1 and 3 tie
    recipe = jcore.make_recipe("step", jcore.SparsityConfig(default=jcore.NMSparsity(2, 4)))
    sparse = recipe.export_sparse(p)
    x = np.random.default_rng(0).standard_normal((2, T // 2, jcfg.d_model)).astype(np.float32)
    return jm, tm, x, {
        "dense": (sparse, carry_over(to_numpy(sparse), device="cpu")),
        "compressed": (comp := jax_compress_params(sparse, recipe.sparsity),
                       carry_over(to_numpy(comp), device="cpu")),
    }


def test_routing_and_kept_pairs_equal(setup):
    jm, tm, x, t = setup
    jp, tp = t["dense"]
    xt = x.reshape(T, -1)
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    _, j_top = jax.lax.top_k(jprobs, jm.top_k)  # the reference's routing
    _, t_top, _ = tmoe.route(torch.from_numpy(xt), tp["router"], tm.top_k)
    np.testing.assert_array_equal(t_top.numpy(), np.asarray(j_top))
    cap = tmoe.moe_capacity(T, tm)
    assert cap == jmoe.moe_capacity(T, jm)
    counts = np.bincount(np.asarray(j_top).reshape(-1), minlength=jm.n_experts)
    assert counts.max() > cap  # pairs really are dropped
    t_counts = torch.bincount(t_top.reshape(-1), minlength=tm.n_experts).numpy()
    np.testing.assert_array_equal(np.minimum(t_counts, cap), np.minimum(counts, cap))


@pytest.mark.parametrize("kind", ["dense", "compressed"])
def test_moe_mlp_matches_reference(setup, kind):
    jm, tm, x, t = setup
    jp, tp = t[kind]
    jy, jaux = jmoe.moe_mlp(jnp.asarray(x), jp, jm)
    ty, taux = tmoe.moe_mlp(torch.from_numpy(x), tp, tm)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LOGIT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **LOGIT_TOL)
