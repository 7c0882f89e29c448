"""Tensor-parallel paged serving (``mesh=``) in the port, held against the
JAX package on the CPU: every leaf's placement of gpt2-paper and of the
other families (full width and reduced) and of their slab and paged caches
against the reference's ``compressed_pspec``/``serving_cache_pspecs`` at a
model axis of 2 and 4;
two gloo ranks (spawned once for the module) serving reduced gpt2-paper in
f32 from the reference's carried-over compressed tree on a preempting fp
pool and an int8 pool, against the reference ``DecodeEngine(mesh=None)``
and the port's own single-rank engine; a 1×1 mesh against ``mesh=None``;
and the refusals.  Nothing here needs the reference's 8-device mesh."""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.distributed.compressed_pspecs import compressed_pspec as jax_compressed_pspec
from repro.distributed.compressed_pspecs import serving_cache_pspecs as jax_cache_pspecs
from repro.distributed.compressed_pspecs import serving_param_pspecs as jax_param_pspecs
from repro.models.model import TransformerLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SamplingParams as JaxSampling
from repro.serving.kv_pool import PagedKVPool as JaxPool
from repro.sparse_infer import CompressedTensor as JaxCompressed
from repro.sparse_infer import compress_params as jax_compress_params
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.compressed_pspecs import (
    compressed_pspec,
    serving_cache_pspecs,
    serving_param_pspecs,
)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import Mesh, make_local_mesh, run_ranks
from repro_torch.launch.serve import serve_rank
from repro_torch.models.cache import SlabLayout
from repro_torch.models.model import init_cache
from repro_torch.serving import DecodeEngine, PagedKVPool
from repro_torch.sparse_infer.compress import CompressedTensor
from torch_parity import assert_streams_agree, port_tree, prompts, trees

# the serving shape of every run here: 2 lanes, max_len 24, pages of 4,
# K = 2; the fp pool of 6 pages preempts, the int8 pool of 12 does not
SERVE = dict(max_batch=2, max_len=24, page_size=4, steps_per_dispatch=2, seed=0)
POOLS = {"fp": dict(num_pages=6), "int8": dict(num_pages=12, kv_quant=True)}
GEN = 8
# the families besides the dense one whose placements are held leaf by leaf
FAMILIES = ("deepseek-v2-lite-16b", "recurrentgemma-9b", "mamba2-2.7b", "starcoder2-3b")


class StandIn:
    """A mesh as the placement rules of both packages read it."""

    axis_names = ("data", "model")

    def __init__(self, model):
        self.devices = np.empty((1, model), dtype=object)


def _specs_by_name(tree, prefix=""):
    """name -> placement tuple (a compressed leaf's: (values, indices))."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_specs_by_name(v, name))
        elif isinstance(v, (JaxCompressed, CompressedTensor)):
            out[name] = (tuple(v.values), tuple(v.indices))
        else:
            out[name] = tuple(v)
    return out


def _meta(tree):
    """The reference's abstract tree as the port's, on the meta device."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}

    def t(x):
        return torch.empty(x.shape, device="meta")

    if isinstance(tree, JaxCompressed):
        return CompressedTensor(t(tree.values), t(tree.indices), tree.n, tree.m,
                                tree.group_axis, tuple(tree.shape), tree.pad)
    return t(tree)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("smoke", [False, True])
def test_placements_match_the_reference(model, smoke):
    """Every leaf of gpt2-paper's compressed serving tree (full width from
    abstract shapes, and reduced, whose 2 KV heads move ``wk``/``wv`` to
    the reduction dim at 4 ranks), and every leaf of its fp and int8 paged
    caches, takes the reference's placement."""
    jcfg = jax_get_config("gpt2-paper")
    tcfg = get_config("gpt2-paper")
    if smoke:
        jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
    sparsity = jcore.SparsityConfig(default=jcore.NMSparsity(2, 4))
    shapes = jax.eval_shape(TransformerLM(jcfg).init, jax.random.PRNGKey(0))
    comp = jax.eval_shape(lambda p: jax_compress_params(p, sparsity), shapes)
    mesh = StandIn(model)
    ref = _specs_by_name(jax_param_pspecs(comp, mesh, cfg=jcfg))
    ours = _specs_by_name(serving_param_pspecs(_meta(comp), mesh, cfg=tcfg))
    assert ours == ref and len(ref) >= 17
    _check_cache_placements(jcfg, tcfg, mesh, batch=2)


def _check_cache_placements(jcfg, tcfg, mesh, batch):
    """The slab cache's (``cache_pspecs``) and the fp and int8 paged caches'
    placements of every leaf against the reference's."""
    jslab = jax.eval_shape(lambda: TransformerLM(jcfg).init_cache(batch, 32))
    ref = _specs_by_name(jax_cache_pspecs(mesh, jslab, None))
    slab = init_cache(tcfg, batch, 32, device="cpu")
    assert _specs_by_name(serving_cache_pspecs(mesh, slab, SlabLayout(32))) == ref
    for quant_on in (False, True):
        kw = dict(max_batch=batch, max_len=32, num_pages=8, page_size=16, quant=quant_on)
        jpool = JaxPool(TransformerLM(jcfg), **kw)
        tpool = PagedKVPool(tcfg, device="cpu", **kw)
        ref = _specs_by_name(jax_cache_pspecs(mesh, jpool.cache, jpool.layout))
        assert _specs_by_name(serving_cache_pspecs(mesh, tpool.cache, tpool.layout)) == ref


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_placements_match_the_reference(arch, model, smoke):
    """Every leaf of the compressed serving tree (full width from abstract
    shapes, and reduced) of DeepSeek-V2-Lite (MLA's head-gated ``w_q`` /
    ``w_ukv``, reduction-TP'd ``w_dkv`` and expert stacks), RecurrentGemma-9B
    (the RG-LRU gates, MQA's one KV head), Mamba2-2.7B (``w_in`` and
    ``conv_w`` moved to the reduction dim) and StarCoder2-3B, and every leaf
    of its slab cache and fp and int8 paged caches (one lane at full
    width), takes the reference's placement."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if smoke:
        jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
    sparsity = jcore.SparsityConfig(default=jcore.NMSparsity(2, 4))
    shapes = jax.eval_shape(TransformerLM(jcfg).init, jax.random.PRNGKey(0))
    comp = jax.eval_shape(lambda p: jax_compress_params(p, sparsity), shapes)
    mesh = StandIn(model)
    ref = _specs_by_name(jax_param_pspecs(comp, mesh, cfg=jcfg))
    assert _specs_by_name(serving_param_pspecs(_meta(comp), mesh, cfg=tcfg)) == ref
    assert any("model" in _names(spec) for spec in ref.values())
    _check_cache_placements(jcfg, tcfg, mesh, batch=1 if not smoke else 2)


def _names(spec) -> set:
    flat = spec[0] + spec[1] if isinstance(spec[0], tuple) else spec
    return {a for e in flat if e is not None for a in (e if isinstance(e, tuple) else (e,))}


@pytest.mark.parametrize("model", [2, 4])
def test_group_guard_matches_the_reference(model):
    """Reduction-dim tensor parallelism only for whole N:M groups per shard
    (``dense_in % (m · ranks) == 0``), else the output dim, else none, as
    the reference decides: 2:4 and 1:8 leaves of several reduction widths,
    a row-sharded ``wo`` and a ``wq`` whose 6 heads the ranks may not
    divide."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("gpt2-paper")), n_heads=6, n_kv=6)
    tcfg = dataclasses.replace(reduced(get_config("gpt2-paper")), n_heads=6, n_kv=6)
    mesh = StandIn(model)
    checked = 0
    for name in ("body/sb_0/attn/wo", "body/sb_0/attn/wq", "body/sb_0/mlp/w_proj"):
        for k, o in ((24, 12), (40, 20), (64, 30), (96, 7)):
            for n, m in ((2, 4), (1, 8)):
                if k % m:
                    continue
                shape = (3, k * n // m, o)
                jct = JaxCompressed(jax.ShapeDtypeStruct(shape, np.float32),
                                    jax.ShapeDtypeStruct(shape, np.uint8), n, m, -2,
                                    (3, k, o))
                tct = _meta({"x": jct})["x"]
                ref = tuple(tuple(p) for p in jax_compressed_pspec(name, jct, mesh, cfg=jcfg))
                assert compressed_pspec(name, tct, mesh, cfg=tcfg) == ref, (name, k, o, n, m)
                checked += 1
    assert checked >= 20


@pytest.fixture(scope="module")
def served():
    """Reduced gpt2-paper in f32 (the reference's compressed tree carried
    over), served on each pool by the reference engine (``mesh=None``), by
    the port's single-rank engine, and by two gloo ranks spawned once."""
    jcfg, tcfg, t = trees()
    jp, tp = t["compressed"]
    reqs = prompts(3, tcfg.vocab, lo=5, step=6)
    out = {"tcfg": tcfg, "tree": tp, "prompts": reqs}
    runs = [dict(pool) for pool in POOLS.values()]
    ranks = run_ranks(serve_rank, (tcfg, runs, reqs, dict(max_new_tokens=GEN), SERVE),
                      model=2, device="cpu", tree=tp, log=lambda m: None)
    for i, (name, pool) in enumerate(POOLS.items()):
        jeng = JaxEngine(TransformerLM(jcfg), jp, **SERVE, **pool)
        uids = [jeng.submit(p, JaxSampling(max_new_tokens=GEN)) for p in reqs]
        jres = jeng.run()
        single = serve_rank(None, tp, tcfg, [pool], reqs, dict(max_new_tokens=GEN), SERVE,
                            device="cpu")[0]
        out[name] = {"reference": [jres[u].tokens for u in uids], "single": single,
                     "ranks": [r[i] for r in ranks]}
    return out


def _streams(rec):
    return [rec["results"][u].tokens for u in sorted(rec["results"])]


@pytest.mark.parametrize("pool", list(POOLS))
def test_two_ranks_match_the_reference_engine(served, pool):
    """The 2-rank streams equal the reference ``DecodeEngine(mesh=None)``'s
    wherever the top-2 margin clears ``torch_parity.MARGIN`` (f32), and
    every request runs to its budget or to ``max_len``."""
    run = served[pool]
    for p, ours, ref in zip(served["prompts"], _streams(run["ranks"][0]), run["reference"]):
        assert len(ours) == min(GEN, SERVE["max_len"] - len(p))
        assert_streams_agree(served["tcfg"], served["tree"], p, ours, ref)


@pytest.mark.parametrize("pool", list(POOLS))
def test_two_ranks_match_one_rank(served, pool):
    """The 2-rank engine gives the port's single-rank engine's streams and
    preemptions (the fp pool preempts), on half the weights and half the
    pages (plus a sink) a rank; the route is the stats form and its
    combine, 2 + 8 collectives per layer and decode step."""
    run, single = served[pool], served[pool]["single"]
    st = run["ranks"][0]["stats"]
    assert _streams(run["ranks"][0]) == _streams(single)
    assert st["preemptions"] == single["stats"]["preemptions"]
    assert (st["preemptions"] > 0) == (pool == "fp")
    assert run["ranks"][0]["kernel_route"] == "shard_map/plain"
    assert single["kernel_route"] == "plain" and single["stats"]["mesh"] is None
    assert st["mesh"] == {"shape": [1, 2], "axes": ["data", "model"], "backend": "gloo",
                          "devices": ["cpu", "cpu"]}
    assert st["collectives_per_decode_step"] == 2 + 8 * served["tcfg"].n_layers
    pages = POOLS[pool]["num_pages"]
    assert st["kv_cache_bytes"] * (pages + 1) == single["stats"]["kv_cache_bytes"] * (
        pages // 2 + 1)
    assert st["weight_bytes_per_step"] < 0.6 * single["stats"]["weight_bytes_per_step"]


@pytest.mark.parametrize("pool", list(POOLS))
def test_ranks_agree(served, pool):
    """Both ranks hold the same streams, the same host page tables after
    every scheduling step, and bit-equal logits of one full forward."""
    a, b = served[pool]["ranks"]
    assert _streams(a) == _streams(b)
    assert a["tables_digest"] == b["tables_digest"]
    assert a["logits_digest"] == b["logits_digest"]
    assert a["stats"]["decode_steps"] == b["stats"]["decode_steps"] > 0


@pytest.mark.parametrize("pool", list(POOLS))
def test_1x1_mesh_is_bit_identical(served, pool):
    """A 1×1 mesh serves the same streams and the same logits, bit for bit,
    as ``mesh=None``, with no collective."""
    mesh = make_local_mesh(1, 1, device="cpu")
    assert mesh.describe()["backend"] == "none" and mesh.group is None
    rec = serve_rank(mesh, served["tree"], served["tcfg"], [POOLS[pool]], served["prompts"],
                     dict(max_new_tokens=GEN), SERVE, device="cpu")[0]
    single = served[pool]["single"]
    assert _streams(rec) == _streams(single)
    assert rec["logits_digest"] == single["logits_digest"]
    assert rec["tables_digest"] == single["tables_digest"]
    assert rec["stats"]["collectives_per_decode_step"] == 0
    assert rec["kernel_route"] == "plain"


def _fake_mesh(data=1, model=2):
    """One rank's view of a mesh no process group backs: enough for the
    checks an engine makes before its first collective."""
    n = data * model
    return Mesh(shape=(data, model), rank=0, device=torch.device("cpu"), backend="none",
                device_names=("cpu",) * n)


@pytest.mark.parametrize("case", ["feature", "pages", "slab", "data", "family", "chunks",
                                  "prefix", "spec", "scheduler"])
def test_refusals(served, case):
    """``kv_shard="feature"`` on a model axis of 2, a pool whose pages do not
    split over the ranks, a data axis > 1 (engine and CLI), and chunked
    prefill, the prefix cache, speculation and the device scheduler over a
    model axis > 1 raise, each naming the rest of tensor parallelism; the
    slab (split into each rank's rows) and a non-dense family (DeepSeek's
    MLA + MoE) are served over a model axis > 1."""
    cfg, tree = served["tcfg"], served["tree"]
    kw = dict(SERVE, num_pages=8, device="cpu", mesh=_fake_mesh())
    todo = "rest of tensor parallelism"
    if case == "feature":
        with pytest.raises(NotImplementedError):
            DecodeEngine(cfg, tree, kv_shard="feature", **kw)
        DecodeEngine(cfg, tree, kv_shard="feature", **{**kw, "mesh": make_local_mesh(
            1, 1, device="cpu")})  # accepted where it is trivial
    elif case == "pages":
        with pytest.raises(ValueError):
            DecodeEngine(cfg, tree, **{**kw, "num_pages": 7})
    elif case == "slab":
        eng = DecodeEngine(cfg, tree, **{**kw, "num_pages": None})
        assert eng.layout.kind == "slab" and (eng.layout.shards, eng.layout.shard) == (2, 0)
        assert eng.cache["body"]["sb_0"]["k"].shape[2] == SERVE["max_len"] // 2
    elif case == "data":
        with pytest.raises(NotImplementedError, match=todo):
            DecodeEngine(cfg, tree, **{**kw, "mesh": _fake_mesh(data=2, model=1)})
        with pytest.raises(SystemExit, match=todo):
            launch_serve.main(["--device", "cpu", "--paged", "--mesh", "2,1"])
    elif case == "family":
        ds = dataclasses.replace(reduced(get_config("deepseek-v2-lite-16b")),
                                 param_dtype="float32")
        eng = DecodeEngine(ds, port_tree("deepseek-v2-lite-16b")[1], **kw)
        attn = eng.params["body"]["sb_0"]["attn"]
        assert (attn["w_ukv"].oshards, attn["w_dkv"].rshards) == (2, 2)
        assert eng.params["body"]["sb_0"]["moe"]["w_gate_e"].rshards == 2
    elif case == "chunks":
        for pages in (8, None):
            with pytest.raises(NotImplementedError, match=todo):
                DecodeEngine(cfg, tree, prefill_chunk=4, **{**kw, "num_pages": pages})
        with pytest.raises(NotImplementedError, match=todo):
            launch_serve.main(["--device", "cpu", "--mesh", "1,2", "--prefill-chunk", "4"])
    elif case == "prefix":
        with pytest.raises(NotImplementedError, match=todo):
            DecodeEngine(cfg, tree, prefix_cache=True, **kw)
    elif case == "spec":
        with pytest.raises(NotImplementedError, match=todo):
            DecodeEngine(cfg, tree, spec_gamma=2, verify_params=tree, **kw)
    else:
        with pytest.raises(NotImplementedError, match=todo):
            DecodeEngine(cfg, tree, max_steps_per_dispatch=4, **kw)


def test_cli_1x1_mesh_matches_no_mesh():
    """``--mesh 1,1`` runs in this process and prints the summary of a
    flag-less run, with its mesh and every rank's bytes."""
    args = ["--device", "cpu", "--batch", "2", "--requests", "3", "--prompt-len", "6",
            "--gen", "4", "--paged", "--page-size", "4", "--num-pages", "8"]
    runs = []
    for extra in ([], ["--mesh", "1,1"]):
        buf = io.StringIO()
        with redirect_stdout(buf):
            summary = launch_serve.main(args + extra)
        assert json.loads(buf.getvalue().strip().splitlines()[-1]) == {"summary": summary}
        runs.append(summary)
    plain, meshed = runs
    assert meshed["greedy_streams"] == plain["greedy_streams"]
    assert plain["mesh"] is None and "per_rank" not in plain
    assert meshed["mesh"]["shape"] == [1, 1] and meshed["kernel_route"] == "plain"
    (rank,) = meshed["per_rank"]
    assert rank["rank"] == 0 and rank["kv_cache_bytes"] == meshed["kv_cache_bytes"] > 0
    assert rank["weight_bytes"] > 0
