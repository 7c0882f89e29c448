"""The recipe-side tools without a data axis, held against the JAX
package: DominoSearch's mixed N:M (``core/domino.py``) on the reduced
gpt2-paper and qwen2-vl-2b trees, the offline switching criteria of
``core/autoswitch.py`` (Eq. 10, Eq. 11 and the replay of Algorithm 2) on
random and edge-case traces, the teacher-student ``SyntheticTask`` and
``make_batch_specs`` (``data/synthetic.py``), and ``init_autoswitch``'s
device.

Tolerances: the same n per leaf and the same emitted patterns, and the same
integer steps, exactly; energy curves within 1e-6 (the reference sums in
f32, the port in float64); ``SyntheticTask``'s outputs and loss on the
reference's weights and batches within 1e-6 relative (f32 matmuls)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as jax_get_config
from repro.core import autoswitch as jasw
from repro.core.domino import _energy_at_n
from repro.core.domino import assigned_ratios as jax_assigned_ratios
from repro.core.domino import domino_search as jax_domino_search
from repro.data.synthetic import SyntheticTask as JaxTask
from repro.data.synthetic import make_batch_specs as jax_batch_specs
from repro.models.model import init_params as jax_init_params
from repro_torch import core as tcore
from repro_torch.checkpoint import carry_over
from repro_torch.configs import get_config
from repro_torch.core.domino import energy_curve
from repro_torch.data import SyntheticTask, make_batch_specs
from repro_torch.utils.tree import tree_items
from torch_parity import to_numpy

DOMINO_ARCHS = ("gpt2-paper", "qwen2-vl-2b")


@pytest.fixture(scope="module")
def domino_trees():
    """Each arch's reduced bf16 init from the reference, and its carry-over."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jax_get_config(arch, smoke=True)
            jp = jax.jit(lambda k: jax_init_params(cfg, k))(jax.random.PRNGKey(0))
            cache[arch] = (jp, carry_over(to_numpy(jp), device="cpu"))
        return cache[arch]

    return get


@pytest.mark.parametrize("m,density", [(8, 0.5), (8, 0.25), (4, 0.5)])
@pytest.mark.parametrize("arch", DOMINO_ARCHS)
def test_domino_search_assigns_the_references_n(domino_trees, arch, m, density):
    """The same n per leaf, the same patterns in the same order (regex, n,
    m, group axis), the base policy kept; the budget met within one
    decrement of the last leaf taken."""
    jp, tp = domino_trees(arch)
    jcfg = jax_domino_search(jp, jcore.SparsityConfig(), m=m, target_density=density)
    tcfg = tcore.domino_search(tp, tcore.SparsityConfig(), m=m, target_density=density)
    assert tcore.assigned_ratios(tcfg) == jax_assigned_ratios(jcfg)
    assert [(r, p.n, p.m, p.group_axis) for r, p in tcfg.layer_patterns] == [
        (r, p.n, p.m, p.group_axis) for r, p in jcfg.layer_patterns]
    assert (tcfg.default.n, tcfg.default.m) == (2, 4)
    sizes = {n: p.numel() for n, p in tree_items(tp)}
    ratios = tcore.assigned_ratios(tcfg)
    total = sum(sizes[n] for n in ratios)
    kept = sum(sizes[n] * int(r.split(":")[0]) / m for n, r in ratios.items())
    assert kept <= density * total + 1e-9
    assert kept > density * total - max(sizes[n] for n in ratios) / m
    assert len({r for r in ratios.values()}) > 1  # mixed
    if arch == "qwen2-vl-2b":
        assert "frontend/frontend_proj" in ratios


def test_energy_curves_match_the_reference(domino_trees):
    """A stacked leaf and a 2-D leaf, every n of 8: the kept share of the
    squared magnitude within 1e-6 of the reference's f32 sums."""
    jp, tp = domino_trees("qwen2-vl-2b")
    jf = dict(tree_items(to_numpy(jp)))
    for name in ("body/sb_0/mlp/w_up", "frontend/frontend_proj"):
        w = dict(tree_items(tp))[name]
        got = energy_curve(w, 8, -2)
        want = [_energy_at_n(jf[name], n, 8, -2) for n in range(9)]
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
        assert got[0] == 0.0 and abs(got[-1] - 1.0) < 1e-12


def test_domino_search_without_a_qualifying_leaf_returns_the_base():
    """No maskable leaf whose group axis divides by m: the base comes back."""
    base = tcore.SparsityConfig()
    tree = {"attn": {"wq": torch.ones((12, 16))}, "norm": {"norm_scale": torch.ones(16)}}
    assert tcore.domino_search(tree, base, m=8) is base
    jtree = {"attn": {"wq": jnp.ones((12, 16))}, "norm": {"norm_scale": jnp.ones(16)}}
    assert jax_domino_search(jtree, jcore.SparsityConfig(), m=8).layer_patterns == ()


def _traces(seed: int, n: int = 400) -> dict:
    """Traces shaped like the real ones, in f32: ‖v_t‖₂ rising and settling
    with noise (Eq. 10), ‖v_t‖₁ decaying onto a floor with noise (Eq. 11),
    and Z_t decaying geometrically with heavy-tailed spikes (Algorithm 2)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    v = (1 - np.exp(-t / rng.uniform(5, 60))) * (1 + 0.3 * rng.standard_normal(n)) + 1e-3
    l1 = (1 + 5 * np.exp(-t / rng.uniform(10, 80))) * (1 + 0.01 * rng.standard_normal(n))
    z = 1e-3 * np.exp(-t / rng.uniform(10, 60)) * (1 + 5 * (rng.random(n) < 0.05))
    return {k: x.astype(np.float32) for k, x in (("v", np.abs(v)), ("l1", l1), ("z", z))}


CRIT_CASES = [
    ("relative_norm", dict(threshold=0.5)), ("relative_norm", dict(threshold=0.05)),
    ("relative_norm", dict(threshold=1e-9)),  # never met
    ("staleness", dict(beta2=0.9)), ("staleness", dict(beta2=0.95, threshold=0.99)),
    ("staleness", dict(beta2=0.999)),  # k = 1000 > the trace
    ("staleness", dict(beta2=0.99, threshold=1e9)),  # never met
    ("offline", dict(window=20, eps=1e-5)), ("offline", dict(window=20, eps=1e-5, t_min=150)),
    ("offline", dict(window=20, eps=1e-5, t_max=60)), ("offline", dict(window=50, eps=1e-4)),
    ("offline", dict(window=50, eps=1e-7, t_max=300)), ("offline", dict(eps=1e-5)),  # T_w 1000
    ("offline", dict(window=1, eps=1e-4, t_min=3, t_max=10)),
]


def _criterion(pkg, kind: str, tr: dict, kw: dict):
    if kind == "relative_norm":
        return pkg.criterion_relative_norm(tr["v"], **kw)
    if kind == "staleness":
        return pkg.criterion_staleness(tr["l1"], **kw)
    return pkg.criterion_autoswitch_offline(tr["z"], pkg.AutoSwitchConfig(**kw))


@pytest.mark.parametrize("case", range(len(CRIT_CASES)))
def test_offline_criteria_give_the_references_step(case):
    """Eq. (10), Eq. (11) and Algorithm 2's replay on five random traces and
    their first 30 steps (shorter than some windows and k): the same Python
    int, from numpy and from a tensor.  The replay's window means are
    differences of f32 prefix sums, as the reference's: a mean below about
    1e-7 of the trace's sum is rounding, and the two libraries sum their
    prefixes in other orders, so every ``eps`` here lies above that."""
    kind, kw = CRIT_CASES[case]
    for seed in range(5):
        for cut in (None, 30):
            tr = {k: v[:cut] for k, v in _traces(seed).items()}
            want = _criterion(jasw, kind, tr, kw)
            got = _criterion(tcore, kind, tr, kw)
            again = _criterion(tcore, kind, {k: torch.from_numpy(v) for k, v in tr.items()}, kw)
            assert type(got) is int and got == again == want, (seed, cut, got, want)


def test_offline_criteria_edge_traces():
    """Fixed traces: the first hit, a hit at the last step, the fill value
    (never met), a trace of one step, and the clip forcing the switch."""
    cfg = tcore.AutoSwitchConfig(window=3, eps=1.0)
    for pkg in (jasw, tcore):
        assert pkg.criterion_relative_norm(np.float32([1, 3, 3.1, 9])) == 2
        assert pkg.criterion_relative_norm(np.float32([1, 3, 9, 9.1])) == 3
        assert pkg.criterion_relative_norm(np.float32([1, 3, 9, 27])) == 3  # never met
        assert pkg.criterion_staleness(np.float32([5, 1, 6, 0.5, 4]), beta2=0.5) == 2
        assert pkg.criterion_staleness(np.float32([5, 1, 2, 0.5, 4]), beta2=0.5) == 4
        assert pkg.criterion_staleness(np.float32([5, 1]), beta2=0.5) == 1  # k = 2 = len
        z = np.float32([5, 5, 5, 0, 0, 0, 0])
        c = pkg.AutoSwitchConfig(window=3, eps=1.0)
        assert pkg.criterion_autoswitch_offline(z, c) == 5
        assert pkg.criterion_autoswitch_offline(z[:2], c) == 1  # shorter than the window
        assert pkg.criterion_autoswitch_offline(z[:4], c) == 3  # never met
        assert pkg.criterion_autoswitch_offline(z, pkg.AutoSwitchConfig(
            window=3, eps=1.0, t_max=2)) == 3  # clip: any step past t_max
        assert pkg.criterion_autoswitch_offline(z, pkg.AutoSwitchConfig(
            window=3, eps=1.0, t_min=5)) == 6
    assert tcore.criterion_autoswitch_offline([5, 5, 5, 0, 0, 0, 0], cfg) == 5  # ints, a list


def test_synthetic_task_apply_and_loss_on_the_references_weights():
    """The reference's teacher and batches, fed to the port's ``apply`` and
    ``loss`` (as a student that is the teacher, and as a random student)."""
    jt, tt = JaxTask(), SyntheticTask(device="cpu")
    teacher = jt.teacher()
    as_student = {"fc1": {"w": teacher["w1"]}, "fc2": {"w": teacher["w2"]}}
    student = jt.student_init(jax.random.PRNGKey(3))
    for step in (0, 5):
        x, y = jt.batch(step, 32)
        tx, ty = torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(y))
        for params in (as_student, student):
            tparams = carry_over(to_numpy(params), device="cpu")
            np.testing.assert_allclose(tt.apply(tparams, tx).numpy(),
                                       np.asarray(jt.apply(params, x)), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(float(tt.loss(tparams, tx, ty)),
                                       float(jt.loss(params, x, y)), rtol=1e-6)


def test_synthetic_task_teacher_is_exactly_n_m_and_batches_are_pure():
    """The port's own teacher keeps exactly n of every m along each input
    axis at 2:4 and 1:4; a batch is a function of (seed, step); the teacher
    fits its noiseless targets exactly; about 5 % of samples are spikes;
    the student's shapes are the reference's."""
    for n, m in ((2, 4), (1, 4)):
        task = SyntheticTask(n=n, m=m, seed=1, device="cpu")
        t = task.teacher()
        for w in (t["w1"], t["w2"]):
            nz = (w != 0).reshape(w.shape[0] // m, m, w.shape[1]).sum(1)
            assert bool((nz == n).all())
        x, y = task.batch(3, 64)
        x2, y2 = task.batch(3, 64)
        assert torch.equal(x, x2) and torch.equal(y, y2)
        assert not torch.equal(x, task.batch(4, 64)[0])
        as_student = {"fc1": {"w": t["w1"]}, "fc2": {"w": t["w2"]}}
        clean = SyntheticTask(n=n, m=m, seed=1, noise=0.0, device="cpu")
        assert float(clean.loss(as_student, *clean.batch(0, 64))) == 0.0
    x, y = task.batch(0, 2048)  # noise 0.01, spikes 21 times that on 1 sample in 20
    spikes = ((y - task.apply(as_student, x)).abs().amax(1) > 0.1).float().mean()
    assert 0.03 < float(spikes) < 0.07
    got = {k: tuple(v["w"].shape) for k, v in task.student_init().items()}
    want = {k: v["w"].shape for k, v in JaxTask().student_init(jax.random.PRNGKey(0)).items()}
    assert got == want


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large", "gpt2-paper"])
def test_make_batch_specs_matches_the_reference(arch):
    """Shapes and types of each key, ``embeds`` in bf16 in place of
    ``tokens`` for a frontend arch; the stand-ins hold no storage."""
    want = jax_batch_specs(jax_get_config(arch), 4, 32)
    got = make_batch_specs(get_config(arch), 4, 32)
    assert sorted(got) == sorted(want)
    for k, spec in got.items():
        assert tuple(spec.shape) == want[k].shape and str(spec.dtype)[6:] == str(want[k].dtype)
        assert spec.device.type == "meta"


def test_init_autoswitch_runs_on_the_card_unless_asked():
    """Like every entry point: the card by default (a RuntimeError here,
    where there is none), the CPU when asked."""
    cfg = tcore.AutoSwitchConfig(window=7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tcore.init_autoswitch(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            SyntheticTask().teacher()
    state = tcore.init_autoswitch(cfg, "cpu")
    assert state.window.device.type == "cpu" and state.window.shape == (7,) and state.count == 0
