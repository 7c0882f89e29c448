"""The seven training recipes of the port held against the JAX package on the
reduced gpt2-paper tree (f32): per-step masks, the active flag and ASP's
one-shot latch bit-exact, forward weights equal in value, the SR-STE term
within one rounding of the jitted reference (bit-exact against its eager
ops, in bf16), and the gradient each recipe lets through (identity for the
STE family, the masked gradient for ASP) equal to JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.models.model import TransformerLM
from repro_torch import core as tcore
from repro_torch.checkpoint import carry_over
from repro_torch.utils.tree import tree_items, tree_map_with_name
from torch_parity import configs, to_numpy

KINDS = ("dense", "ste", "sr_ste", "asp", "decay", "step", "step_sr")
# prune at step 2; decay dense until 1, then n falls every 2 steps
KW = dict(prune_at=2, dense_until=1, decay_interval=2, sr_lambda=2e-4)
STEPS = 6  # covers ASP's prune, the STEP switch and three decay stages
# the jitted reference fuses g + (λ(1−Π))·w into one multiply-add: one
# rounding of the term (|term| ~ 1e-5) fewer than the port's two
SR_TOL = dict(rtol=1e-6, atol=1e-10)


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, np.float32).view(np.int32)


def _sparsity(core):
    # a second pattern on w_fc gives the decay schedule two group sizes
    return core.SparsityConfig(default=core.NMSparsity(2, 4),
                               layer_patterns=(("w_fc", core.NMSparsity(2, 8)),))


def _setup(kind, dtype=jnp.float32):
    jcfg, _ = configs()
    pj = jax.tree_util.tree_map(lambda x: x.astype(dtype),
                                TransformerLM(jcfg).init(jax.random.PRNGKey(0)))
    pt = carry_over(to_numpy(pj), device="cpu")
    return (jcore.make_recipe(kind, _sparsity(jcore), **KW),
            tcore.make_recipe(kind, _sparsity(tcore), **KW), pj, pt)


def _port_mask_tree(masks, params):
    """The reference's full mask tree from the port's sparse dict."""
    return tree_map_with_name(
        lambda n, p: masks[n].mask if n in masks else torch.ones_like(p), params)


def _assert_bits(t_tree, j_tree, what):
    jf = dict(tree_items(to_numpy(j_tree)))
    for name, leaf in tree_items(t_tree):
        np.testing.assert_array_equal(_bits(leaf), _bits(jf[name]), err_msg=f"{what} {name}")


@pytest.mark.parametrize("kind", KINDS)
def test_masks_forward_and_sr_term_follow_the_reference(kind):
    jr, tr, pj, pt = _setup(kind)
    js, ts = jr.init_state(pj), tr.init_state(pt)
    # jitted once: the reference's lax.cond would otherwise compile every call
    j_masks, j_forward, j_post = (jax.jit(f) for f in (
        jr.masks_for_step, jr.forward_params, jr.grad_postprocess))
    rng = np.random.default_rng(0)
    seen_active = False
    for t in range(STEPS):
        phase2 = t >= 3  # the STEP kinds switch entering step 3
        jm, ja, js = j_masks(pj, js, jnp.asarray(phase2))
        tm, ta, ts = tr.masks_for_step(pt, ts, phase2)
        assert ta == bool(ja), f"active at step {t}"
        seen_active |= ta
        assert ts.step == int(js.step)
        _assert_bits(_port_mask_tree(tm, pt), jm, f"mask at step {t}")
        if kind == "asp":
            assert ts.pruned == bool(js.pruned) == (t >= KW["prune_at"])
            _assert_bits(ts.fixed_mask, js.fixed_mask, f"ASP latch at step {t}")
        jf = dict(tree_items(to_numpy(j_forward(pj, jm, ja))))
        for name, leaf in tree_items(tr.forward_params(pt, tm, ta)):
            np.testing.assert_array_equal(leaf.detach().numpy(), jf[name], err_msg=name)
        g_np = to_numpy(jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), pj))
        jg = dict(tree_items(to_numpy(
            j_post(jax.tree_util.tree_map(jnp.asarray, g_np), pj, jm, ja))))
        for name, g in tree_items(tr.grad_postprocess(carry_over(g_np, device="cpu"), pt, tm, ta)):
            np.testing.assert_allclose(g.numpy(), jg[name], **SR_TOL, err_msg=f"step {t} {name}")
        # move the weights so the masks change from step to step
        d_np = to_numpy(jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.05, p.dtype), pj))
        pj = jax.tree_util.tree_map(lambda p, d: p + d, pj, d_np)
        for name, leaf in tree_items(pt):
            leaf += torch.from_numpy(np.array(dict(tree_items(d_np))[name]))
    assert seen_active == (kind != "dense")


def test_sr_term_in_bf16_rounds_as_the_reference():
    """Against the reference's eager ops, on the MLP leaves (2:8 and 2:4)."""
    jr, tr, pj, pt = _setup("sr_ste", jnp.bfloat16)
    pj, pt = ({"body": {"sb_0": {"mlp": p["body"]["sb_0"]["mlp"]}}} for p in (pj, pt))
    jm, ja, _ = jr.masks_for_step(pj, jr.init_state(pj), jnp.asarray(False))
    tm, ta, _ = tr.masks_for_step(pt, tr.init_state(pt), False)
    rng = np.random.default_rng(1)
    g_np = to_numpy(jax.tree_util.tree_map(
        lambda p: np.asarray(rng.standard_normal(p.shape), p.dtype), pj))
    jg = jr.grad_postprocess(jax.tree_util.tree_map(jnp.asarray, g_np), pj, jm, ja)
    tg = tr.grad_postprocess(carry_over(g_np, device="cpu"), pt, tm, ta)
    _assert_bits(tg, jg, "bf16 SR-STE gradient")


@pytest.mark.parametrize("kind", ["ste", "asp", "step"])
def test_gradient_through_the_forward_weights(kind):
    """d/dw sum(C ⊙ forward(w)): C itself for STE (identity), C ⊙ Π for ASP
    (pruned weights stay dead), equal to JAX's gradient."""
    jr, tr, pj, pt = _setup(kind)
    js, ts = jr.init_state(pj), tr.init_state(pt)
    for _ in range(KW["prune_at"] + 1):  # past ASP's prune step
        jm, ja, js = jr.masks_for_step(pj, js, jnp.asarray(True))
        tm, ta, ts = tr.masks_for_step(pt, ts, True)
    assert ta
    rng = np.random.default_rng(2)
    c_np = to_numpy(jax.tree_util.tree_map(
        lambda p: np.asarray(rng.standard_normal(p.shape), p.dtype), pj))
    jgrad = jax.jit(jax.grad(lambda p: sum(
        jnp.sum(a * c) for a, c in zip(jax.tree_util.tree_leaves(jr.forward_params(p, jm, ja)),
                                       jax.tree_util.tree_leaves(c_np)))))(pj)
    leaves = tree_map_with_name(lambda _, p: p.detach().requires_grad_(), pt)
    cf = dict(tree_items(c_np))
    fwd = dict(tree_items(tr.forward_params(leaves, tm, ta)))
    loss = sum((fwd[n] * torch.from_numpy(cf[n])).sum() for n in fwd)
    flat = list(tree_items(leaves))
    grads = dict(zip([n for n, _ in flat], torch.autograd.grad(loss, [p for _, p in flat])))
    jf = dict(tree_items(to_numpy(jgrad)))
    for name, g in grads.items():
        expect = cf[name] * (tm[name].mask.numpy() if kind == "asp" and name in tm else 1.0)
        np.testing.assert_array_equal(g.numpy(), expect, err_msg=name)
        np.testing.assert_array_equal(g.numpy(), jf[name], err_msg=name)


@pytest.mark.parametrize("kind", ["step", "dense"])
def test_export_is_the_kernel_select(kind):
    """final_masks equal the reference's bit for bit; export_sparse equals
    its Π⊙w in value and is the kernel's where(Π, w, 0), +0.0 where pruned."""
    jr, tr, pj, pt = _setup(kind)
    jmask = jr.final_masks(pj)
    _assert_bits(tr.final_masks(pt), jmask, "final mask")
    _assert_bits(tr.export_sparse(pt),
                 jax.tree_util.tree_map(lambda p, m: jnp.where(m != 0, p, 0.0), pj, jmask),
                 "export")
    je = dict(tree_items(to_numpy(jr.export_sparse(pj))))
    for name, leaf in tree_items(tr.export_sparse(pt)):
        np.testing.assert_array_equal(leaf.numpy(), je[name], err_msg=name)


def test_ste_primitives_sparsity_fraction_and_maskable_map():
    """straight_through_mask: the value w ⊙ Π and the identity gradient;
    sparsity_fraction and the per-leaf pattern map as the reference's."""
    rng = np.random.default_rng(4)
    w_np = rng.standard_normal((8, 6)).astype(np.float32)
    mk_np = (rng.random((8, 6)) > 0.5).astype(np.float32)
    c_np = rng.standard_normal((8, 6)).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda w: jnp.sum(
        jcore.straight_through_mask(w, jnp.asarray(mk_np)) * c_np))(jnp.asarray(w_np))
    w = torch.from_numpy(w_np).requires_grad_()
    tv = (tcore.straight_through_mask(w, torch.from_numpy(mk_np)) * torch.from_numpy(c_np)).sum()
    (tg,) = torch.autograd.grad(tv, [w])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tg.numpy(), c_np)
    assert float(tcore.sparsity_fraction(torch.from_numpy(mk_np))) == pytest.approx(
        float(jcore.sparsity_fraction(jnp.asarray(mk_np))), rel=1e-6)
    jr, tr, pj, pt = _setup("step")
    jmap = dict(tree_items(jax.tree_util.tree_map(
        str, jcore.maskable_map(pj, jr.sparsity), is_leaf=lambda x: x is None)))
    tmap = {n: str(p) for n, p in tree_items(tcore.maskable_map(pt, tr.sparsity))}
    assert tmap == jmap
    assert tcore.sparsity_report(pt, tr.sparsity) == jcore.sparsity_report(pj, jr.sparsity)
