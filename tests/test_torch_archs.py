"""The five dense and MoE archs that need no new layer (starcoder2-3b,
minitron-4b, command-r-plus-104b, qwen1.5-110b, dbrx-132b) and the two
with stub frontends on their token paths (qwen2-vl-2b with M-RoPE,
musicgen-large) in the port, held against the JAX package: the full configs field by field, the layer
plan and the tree's leaf names, shapes and types, the maskable map, the
streamed export of the new trees (mamba2-2.7b's too), and on the reduced
f32 models carried across from the JAX package: forward
logits, and greedy streams of the slab and paged engines against the
reference's ``DecodeEngine(mesh=None)`` (its slab engine, served once an
arch).

Tolerances: f32 logits within 1e-5 relative or 1e-4 absolute (sums in
other orders); greedy streams token for token wherever the f32 top-2
margin clears ``torch_parity.MARGIN``; plans, tree keys, masks and page
counts exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as jax_get_config
from repro.models.model import TransformerLM
from repro.models.model import init_params as jax_init_params
from repro.models.model import layer_plan as jax_layer_plan
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SamplingParams as JaxSampling
from repro_torch import core as tcore
from repro_torch.configs import get_config
from repro_torch.models import model as tmodel
from repro_torch.serving import DecodeEngine, SamplingParams
from repro_torch.sparse_infer import CompressedTensor, compress_params, export_compressed
from repro_torch.utils.tree import tree_items
from torch_parity import assert_streams_agree, prompts, to_numpy, trees

ARCHS = ("starcoder2-3b", "minitron-4b", "command-r-plus-104b", "qwen1.5-110b", "dbrx-132b",
         "qwen2-vl-2b", "musicgen-large")
TOL = dict(rtol=1e-5, atol=1e-4)
MAX_LEN, PS = 40, 4
ENGINE = dict(max_batch=2, max_len=MAX_LEN, seed=0, steps_per_dispatch=4)


@pytest.fixture(scope="module")
def setups():
    """Each arch's ``trees`` (JAX and port), built once on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = trees(arch=arch)
        return cache[arch]

    return get


@pytest.fixture(scope="module")
def jax_streams(setups):
    """Each arch's greedy streams, finish reasons and prefill batches from
    the reference's slab engine, served once on first use: three requests
    of 6-16 prompt tokens over two lanes (slot reuse), K = 4."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, tcfg, t = setups(arch)
            eng = JaxEngine(TransformerLM(jcfg), t["compressed"][0], **ENGINE)
            reqs = list(zip(prompts(3, tcfg.vocab, lo=6, step=5), [10, 7, 12]))
            cache[arch] = (reqs, *_run(eng, reqs, JaxSampling), eng.prefill_batches)
        return cache[arch]

    return get


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS + ("mamba2-2.7b",))
def test_config_equals_the_reference_field_by_field(arch, smoke):
    """Every field the port's config has equals the reference's (its MoE or
    SSM sub-config field by field), ``frontend`` included; the one field of
    the reference the port leaves out is ``sub_quadratic`` (the reference's
    long-context cell), and of the sub-configs' the router's dtype, f32."""
    t, j = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
    tf, jf = _fields(t), _fields(j)
    for name, value in tf.items():
        if dataclasses.is_dataclass(value):
            sub = _fields(jf[name])
            assert _fields(value) == {k: sub[k] for k in _fields(value)}, name
            assert {k: v for k, v in sub.items() if k not in _fields(value)} in (
                {}, {"router_dtype": "float32"}), name
        else:
            assert value == jf[name], name
    assert set(jf) - set(tf) == {"sub_quadratic"}
    assert (tf["frontend"] != "none") == (arch in ("qwen2-vl-2b", "musicgen-large"))


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_and_tree(arch):
    """The full config's plan is the reference's; the reduced model's own
    init has the reference's leaf names, shapes and types (DBRX's expert
    stacks without a shared expert, command-r-plus without an unembedding,
    qwen1.5's and starcoder2's biases)."""
    assert (dataclasses.astuple(tmodel.layer_plan(get_config(arch)))
            == dataclasses.astuple(jax_layer_plan(jax_get_config(arch))))
    tcfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
    jtree = dict(tree_items(to_numpy(jax.jit(lambda k: jax_init_params(jcfg, k))(
        jax.random.PRNGKey(0)))))
    ttree = dict(tree_items(tmodel.init_params(tcfg, device="cpu")))
    assert sorted(ttree) == sorted(jtree)
    for name, leaf in ttree.items():
        assert tuple(leaf.shape) == jtree[name].shape, name
        assert str(leaf.dtype)[6:] == str(jtree[name].dtype), name
    assert ("unembed/out_embed" in ttree) == (not tcfg.tie_embeddings)
    assert any("bias_q" in n for n in ttree) == tcfg.qkv_bias
    moe = [n for n in ttree if "/moe/" in n]
    assert bool(moe) == (arch == "dbrx-132b") and not any("shared" in n for n in moe)


@pytest.mark.parametrize("arch", ARCHS)
def test_maskable_map_matches_the_reference(arch):
    """The 2:4 policy picks the same leaves, with the same pattern and
    group axis, on the full config's leaf names and shapes."""
    jpol = jcore.SparsityConfig(default=jcore.NMSparsity(2, 4))
    tpol = tcore.SparsityConfig(default=tcore.NMSparsity(2, 4))
    shapes = jax.eval_shape(lambda k: jax_init_params(jax_get_config(arch), k),
                            jax.random.PRNGKey(0))
    n_masked = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        jpat, tpat = jpol.pattern_for(name, leaf.shape), tpol.pattern_for(name, leaf.shape)
        assert (jpat is None) == (tpat is None), name
        if tpat is not None:
            n_masked += 1
            assert (tpat.n, tpat.m, tpat.group_axis % len(leaf.shape)) == (
                jpat.n, jpat.m, jpat.group_axis % len(leaf.shape)), name
    # q/k/v/o and the MLP's (or the expert stacks') two or three matrices,
    # and a stub frontend's projection
    cfg = get_config(arch)
    assert n_masked == 4 + (3 if cfg.mlp == "swiglu" else 2) + (cfg.frontend != "none")


@pytest.mark.parametrize("arch", ["dbrx-132b", "command-r-plus-104b", "mamba2-2.7b",
                                  "qwen2-vl-2b"])
def test_streamed_export_equals_whole_tree(arch):
    """``export_compressed`` takes the new trees leaf by leaf (DBRX's expert
    stacks slice by slice, the tied embedding, Mamba-2's mixer with its f32
    recurrence leaves) bit-identically to ``compress_params`` of
    ``export_sparse`` of the port's own bf16 init."""
    tcfg = get_config(arch, smoke=True)
    recipe = tcore.make_recipe("step", tcore.SparsityConfig(default=tcore.NMSparsity(2, 4)))
    params = tmodel.init_params(tcfg, seed=3, device="cpu")
    whole = dict(tree_items(compress_params(recipe.export_sparse(params), recipe.sparsity)))
    streamed, _ = export_compressed(params, recipe)
    assert sorted(dict(tree_items(streamed))) == sorted(whole)
    for name, leaf in tree_items(streamed):
        ref = whole[name]
        pairs = ([(leaf.values, ref.values), (leaf.indices, ref.indices)]
                 if isinstance(leaf, CompressedTensor) else [(leaf, ref)])
        for a, b in pairs:
            assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(setups, arch):
    """The compressed reduced model carried across: 19 tokens, f32."""
    jcfg, tcfg, t = setups(arch)
    jp, tp = t["compressed"]
    assert any(isinstance(x, CompressedTensor) for _, x in tree_items(tp))
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 19))
    jm = TransformerLM(jcfg)  # jitted: eager jnp compiles each op of a new shape on first use
    jl, _, _ = jax.jit(lambda p, x: jm.forward(p, {"tokens": x}, remat=False))(
        jp, jnp.asarray(toks))
    tl, _ = tmodel.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def _run(eng, reqs, sp_cls):
    uids = [eng.submit(p, sp_cls(max_new_tokens=n)) for p, n in reqs]
    res = eng.run()
    return [res[u].tokens for u in uids], [res[u].finish_reason for u in uids]


@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_jax(setups, jax_streams, arch, layout):
    """The port's slab and paged engines against the reference's slab
    engine on the same traffic (bucketed prefill, then decode): token for
    token wherever the top-2 margin clears ``MARGIN``; the same prefill
    batches, and every page back in the pool at the end."""
    _, tcfg, t = setups(arch)
    tp = t["compressed"][1]
    reqs, jt, jr, j_batches = jax_streams(arch)
    paged = dict(num_pages=24, page_size=PS) if layout == "paged" else {}
    teng = DecodeEngine(tcfg, tp, device="cpu", **ENGINE, **paged)
    tt, tr = _run(teng, reqs, SamplingParams)
    for (p, _), a, b in zip(reqs, tt, jt):
        assert_streams_agree(tcfg, tp, p, a, b)
    if tt == jt:
        assert tr == jr
    assert teng.prefill_batches == j_batches
    if layout == "paged":
        assert teng.pool.free_pages == 24 and teng.kernel_route() == "plain"
