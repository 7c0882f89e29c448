"""The port's STEP optimizer and AutoSwitch held step by step against the
JAX package on one shared numpy gradient stream.

Both sides see identical gradients, so the moments may differ only by f32
rounding of the same formulas in another order (``RTOL``); the phase flag
and the switch step ``t0`` must be equal.  The stream decays geometrically
(the gradient scale shrinks by ``DECAY`` a step), so the AutoSwitch window
mean falls by about a fifth each step and crosses ``eps`` with a margin no
rounding can close."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.optim as jopt
import repro.optim.schedules as jsched
from repro.optim.schedules import linear_warmup_cosine_decay as jax_warmup_cosine
from repro_torch import core as tcore
import repro_torch.optim as topt
import repro_torch.optim.schedules as tsched
from repro_torch.optim import apply_updates, linear_warmup_cosine_decay
from repro_torch.utils.tree import tree_items

# f32 formulas evaluated in another order (and PyTorch's division by a
# scalar as a multiply by its reciprocal): a few ulps, amplified by no
# division by a small number since the gradients are equal
RTOL, ATOL = 1e-5, 1e-12
DECAY = 0.9
STEPS = 40
SHAPES = {"body": {"w": (8, 16)}, "embed": {"tok_embed": (6, 4)}, "norm_scale": (16,)}


def _tree(fn, shapes=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(k, v) for k, v in shapes.items()}


def _grads(t, seed=0):
    """Step t's gradient tree, as numpy: noisy, shrinking by DECAY a step."""
    rng = np.random.default_rng(seed * 1000 + t)
    return _tree(lambda _, s: (rng.standard_normal(s) * 0.1 * DECAY ** t + 0.02 * DECAY ** t)
                 .astype(np.float32))


def _params():
    rng = np.random.default_rng(7)
    return _tree(lambda _, s: rng.standard_normal(s).astype(np.float32))


def _flat(tree):
    return {k: np.asarray(v) for k, v in tree_items(tree)}


def _close(t_tree, j_tree, what):
    tf, jf = _flat(t_tree), _flat(j_tree)
    assert tf.keys() == jf.keys(), what
    for k in tf:
        np.testing.assert_allclose(tf[k], jf[k], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


def _run(jcfg, tcfg, steps=STEPS):
    """Step both optimizers on the shared stream; compare every step;
    return the per-step (phase2, t0) of the port."""
    jopt, topt = jcore.step_optimizer(jcfg), tcore.step_optimizer(tcfg)
    p_np = _params()
    jparams = jax.tree_util.tree_map(jnp.asarray, p_np)
    tparams = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), p_np)
    js, ts = jopt.init(jparams), topt.init(tparams)
    trace = []
    for t in range(steps):
        g = _grads(t)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jparams)
        tu, ts = topt.update(jax.tree_util.tree_map(torch.from_numpy, g), ts, tparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, ju)
        apply_updates(tparams, tu)
        assert ts.step == int(js.step) == t + 1
        assert ts.phase2 == bool(js.phase2), f"phase2 at step {t + 1}"
        assert ts.t0 == int(js.t0), f"t0 at step {t + 1}"
        for what in ("m", "v", "precond"):
            _close(getattr(ts, what), getattr(js, what), f"{what} at step {t + 1}")
        _close(tu, ju, f"update at step {t + 1}")
        np.testing.assert_allclose(float(ts.z_bar), float(js.z_bar), rtol=RTOL)
        assert ts.autoswitch.count == int(js.autoswitch.count)
        np.testing.assert_allclose(ts.autoswitch.window.numpy(),
                                   np.asarray(js.autoswitch.window), rtol=RTOL, atol=0)
        trace.append((ts.phase2, ts.t0))
    _close(tparams, jparams, "params after the run")
    return trace


def _cfgs(**kw):
    asw = kw.pop("autoswitch", {})
    base = dict(learning_rate=1e-2, b2=0.9, eps=1e-8)
    base.update(kw)
    return (jcore.StepConfig(autoswitch=jcore.AutoSwitchConfig(**asw), **base),
            tcore.StepConfig(autoswitch=tcore.AutoSwitchConfig(**asw), **base))


@pytest.mark.parametrize("option,t0", [("I", 26), ("II", 24)])
def test_autoswitch_decides_the_same_step(option, t0):
    """The window mean (T_w = 10) crosses eps = 1e-4 by 2 % or more (on this
    stream it falls 5-10 % a step), at step 26 (option I) or 24 (II)."""
    trace = _run(*_cfgs(autoswitch=dict(option=option, eps=1e-4)))
    assert trace[t0 - 2] == (False, 0) and trace[t0 - 1] == (True, t0), trace


def test_switch_at_fixes_t0():
    trace = _run(*_cfgs(switch_at=7), steps=12)
    assert trace[-1] == (True, 7) and trace[5] == (False, 0) and trace[6] == (True, 7)


def test_update_v_in_phase2_and_schedule():
    jcfg, tcfg = _cfgs(switch_at=8, update_v_in_phase2=True)
    _run(dataclasses.replace(jcfg, learning_rate=jax_warmup_cosine(1e-2, 5, 30)),
         dataclasses.replace(tcfg, learning_rate=linear_warmup_cosine_decay(1e-2, 5, 30)),
         steps=16)


@pytest.mark.parametrize("t_min,t_max,t0", [(30, None, 31), (None, 12, 13)])
def test_clipping_bounds(t_min, t_max, t0):
    """Option I would switch at 26: t_min = 30 holds it to 31, t_max = 12
    forces it at 13."""
    trace = _run(*_cfgs(autoswitch=dict(eps=1e-4, t_min=t_min, t_max=t_max)))
    assert trace[-1] == (True, t0), trace


def test_beta2_follows_b2():
    _, tcfg = _cfgs(b2=0.98)
    assert tcfg.autoswitch.beta2 == 0.98 and tcfg.autoswitch.t_w == 50
    assert tcore.AutoSwitchConfig(beta2=0.999).t_w == 1000


def test_phase1_is_adam():
    """Before the switch STEP is plain Adam: equal to the port's Adam
    bit for bit, and to the reference's within RTOL."""
    _, tcfg = _cfgs(switch_at=100)
    step, tad, jad = tcore.step_optimizer(tcfg), topt.adam(1e-2, b2=0.9), jopt.adam(1e-2, b2=0.9)
    p_np = _params()
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), p_np)
    ss, sa = step.init(tp), tad.init(tp)
    js = jad.init(jax.tree_util.tree_map(jnp.asarray, p_np))
    for t in range(6):
        g = _grads(t)
        us, ss = step.update(jax.tree_util.tree_map(torch.from_numpy, g), ss, tp)
        ua, sa = tad.update(jax.tree_util.tree_map(torch.from_numpy, g), sa, tp)
        uj, js = jad.update(jax.tree_util.tree_map(jnp.asarray, g), js)
        for k, v in _flat(us).items():
            np.testing.assert_array_equal(v, _flat(ua)[k])
        _close(ua, uj, f"adam update at step {t + 1}")


@pytest.mark.parametrize("kind", ["adamw", "sgd", "nesterov"])
def test_baselines_match(kind):
    if kind == "adamw":
        mk = lambda a: a.adamw(1e-2, weight_decay=0.1, mask=lambda p: {
            k: v for k, v in jax.tree_util.tree_map(lambda x: x.ndim > 1, p).items()})
    else:
        mk = lambda a: a.sgd(1e-2, momentum=0.9, nesterov=kind == "nesterov")
    jo, to = mk(jopt), mk(topt)
    p_np = _params()
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), p_np)
    js, ts = jo.init(jp), to.init(tp)
    for t in range(5):
        g = _grads(t)
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = to.update(jax.tree_util.tree_map(torch.from_numpy, g), ts, tp)
        _close(tu, ju, f"{kind} update at step {t + 1}")


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (3e-3,)),
    ("linear_warmup_cosine_decay", (3e-3, 10, 100)),
    ("linear_decay", (3e-3, 100, 10)),
    ("inverse_sqrt_schedule", (3e-3, 10)),
])
def test_schedules_match(name, args):
    """The rates in f32, at the warm-up's edges and through the decay."""
    j, t = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(t(step), float(j(jnp.asarray(step))), rtol=1e-6, err_msg=step)
