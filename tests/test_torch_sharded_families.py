"""Tensor-parallel serving of every family and of the slab in the port,
held against the JAX package on the CPU: two gloo ranks, spawned once for
the module (``launch.serve.serve_jobs``), serve the compressed trees in f32
(reduced shapes, carried over to the reference) of recurrentgemma-9b (RG-LRU and
a window of 16 that the traffic passes), mamba2-2.7b (SSM heads split over
the ranks, the table-less pool), starcoder2-3b and gpt2-paper on the split
slab and on pools, and DeepSeek-V2-Lite (MLA + MoE: K3's MLA form, the
sharded expert stacks).  The streams are the reference
``DecodeEngine(mesh=None)``'s on the same pool, int8 pools and a
preempting pool included (token for token, or DeepSeek's through
``torch_parity.assert_streams_agree``: its top-k routing has near-ties),
and the port's single-rank streams; the ranks agree on streams, page
tables and one forward's logits, and every leaf of a rank's cache has the
shape its placement gives.
DeepSeek's 2-rank forward logits lie within 1e-4 of the reference
forward's, the reference's own tolerance."""
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compressed_pspecs import serving_param_pspecs as jax_param_pspecs
from repro.models.model import TransformerLM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SamplingParams as JaxSampling
from repro_torch.distributed.compressed_pspecs import serving_cache_pspecs
from repro_torch.distributed.sharding import sanitize_spec
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.serve import serve_jobs, serve_rank
from repro_torch.models.cache import SlabLayout
from test_torch_sharded import StandIn, _specs_by_name
from torch_parity import LOGIT_TOL, assert_streams_agree, configs, port_tree, prompts, to_jax

# 2 lanes of max_len 24, pages of 4, K = 2; prompts of 5, 11 and 17 tokens
# and 6 new ones (the third request waits for a lane; the longest passes
# RecurrentGemma's window of 16)
SERVE = dict(max_batch=2, max_len=24, page_size=4, steps_per_dispatch=2, seed=0)
GEN = 6
RANKS = 2
# each arch's runs: the slab, an fp pool, an int8 pool (an SSM arch's
# pool holds no page), starcoder2's pool of 6 pages, which preempts, and
# an odd slab of 23 rows, which the ranks do not split (whole on each, as
# the reference's sanitized placement holds it)
RUNS = {
    "recurrentgemma-9b": {"slab": {}, "fp": dict(num_pages=12),
                          "int8": dict(num_pages=12, kv_quant=True)},
    "mamba2-2.7b": {"slab": {}, "fp": dict(num_pages=12)},
    "starcoder2-3b": {"slab": {}, "fp": dict(num_pages=12),
                      "int8": dict(num_pages=12, kv_quant=True),
                      "preempting": dict(num_pages=6)},
    "gpt2-paper": {"slab": {}, "odd": dict(max_len=23)},
    "deepseek-v2-lite-16b": {"slab": {}, "fp": dict(num_pages=12),
                             "int8": dict(num_pages=12, kv_quant=True),
                             "odd": dict(max_len=23)},
}
ALL = [(arch, run) for arch, runs in RUNS.items() for run in runs]
# the runs held to the reference's streams token for token
EXACT = [(arch, run) for arch, run in ALL if arch != "deepseek-v2-lite-16b"]
# a pool's leaves whose pages axis a rank holds its share of, plus a sink page
POOL_LEAVES = ("k", "v", "ckv", "krope", "k_scale", "v_scale", "ckv_scale", "krope_scale")


def _streams(rec):
    return [rec["results"][u].tokens for u in sorted(rec["results"])]


@pytest.fixture(scope="module")
def served():
    """Every arch's reduced f32 compressed tree (made in the port, carried
    to the JAX package), its traffic served by two ranks (one spawn for
    all, in a thread beside the rest), by the port's single-rank engine,
    and by the reference engine on each run's layout (4 threads: its
    compiles dominate the module's time); DeepSeek's first prompt's
    forward logits from the ranks (``logits=True``) and from the
    reference."""
    out, jobs, port_trees = {}, [], {}
    for arch, runs in RUNS.items():
        jcfg, _ = configs(arch)
        tcfg, tp = port_tree(arch)
        reqs = prompts(3, tcfg.vocab, lo=5, step=6)
        port_trees[arch] = tp
        jobs.append(dict(cfg=tcfg, tree=arch, prompts=reqs, sampling=dict(max_new_tokens=GEN),
                         runs=[dict(run, logits=name == "slab") for name, run in runs.items()],
                         engine_kw=SERVE))
        out[arch] = dict(jcfg=jcfg, tcfg=tcfg, jtree=to_jax(tp), tree=tp, prompts=reqs)
    ranks = {}

    def spawn():
        try:
            ranks["out"] = run_ranks(serve_jobs, (jobs,), model=RANKS, device="cpu",
                                     tree=port_trees, log=lambda m: None)
        except BaseException as exc:  # re-raised below
            ranks["error"] = exc

    def reference(s, pool):
        jeng = JaxEngine(TransformerLM(s["jcfg"]), s["jtree"], **{**SERVE, **pool})
        uids = [jeng.submit(p, JaxSampling(max_new_tokens=GEN)) for p in s["prompts"]]
        jres = jeng.run()
        return [jres[u].tokens for u in uids]

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        for arch, runs in RUNS.items():  # first: the reference's threads hold the GIL
            s = out[arch]
            s["single"] = dict(zip(runs, serve_rank(
                None, s["tree"], s["tcfg"], list(runs.values()), s["prompts"],
                dict(max_new_tokens=GEN), SERVE, device="cpu")))
        with ThreadPoolExecutor(4) as ex:
            refs = {(arch, name): ex.submit(reference, out[arch], pool)
                    for arch, runs in RUNS.items() for name, pool in runs.items()}
        for (arch, name), ref in refs.items():
            out[arch].setdefault("reference", {})[name] = ref.result()
        s = out["deepseek-v2-lite-16b"]
        jm = TransformerLM(s["jcfg"])
        s["reference_logits"] = np.asarray(jax.jit(
            lambda p, x: jm.forward(p, {"tokens": x}, remat=False)[0])(
                s["jtree"], jnp.asarray([s["prompts"][0]])))
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    for j, arch in enumerate(RUNS):
        out[arch]["ranks"] = {name: [r[j]["runs"][i] for r in ranks["out"]]
                              for i, name in enumerate(RUNS[arch])}
    return out


@pytest.mark.parametrize("arch,run", EXACT)
def test_two_ranks_give_the_reference_streams(served, arch, run):
    """Two ranks on the split slab, an odd slab or a pool (fp, int8,
    preempting) give the reference engine's (``mesh=None``) greedy streams
    on the same layout, token for token, every request to its budget."""
    s = served[arch]
    ours = _streams(s["ranks"][run][0])
    assert ours == s["reference"][run]
    assert all(len(x) == GEN for x in ours)


@pytest.mark.parametrize("arch,run", ALL)
def test_two_ranks_give_one_ranks_streams(served, arch, run):
    """Every run on two ranks (int8 pools and the preempting pool included)
    gives the port's single-rank engine's streams and preemptions, and
    holds half the weights and about half the cache a rank (an odd slab:
    all of it)."""
    s = served[arch]
    rank, single = s["ranks"][run][0], s["single"][run]
    assert _streams(rank) == _streams(single)
    st, st1 = rank["stats"], single["stats"]
    assert st["preemptions"] == st1["preemptions"]
    assert (st["preemptions"] > 0) == (run == "preempting")
    assert st["mesh"]["shape"] == [1, RANKS] and st1["mesh"] is None
    assert st["weight_bytes_per_step"] < 0.7 * st1["weight_bytes_per_step"]
    if run == "odd":
        assert st["kv_cache_bytes"] == st1["kv_cache_bytes"]
    else:
        assert st["kv_cache_bytes"] < st1["kv_cache_bytes"]


@pytest.mark.parametrize("arch,run", ALL)
def test_ranks_agree(served, arch, run):
    """Both ranks hold the same streams, the same host page tables after
    every scheduling step and bit-equal logits of one full forward."""
    a, b = served[arch]["ranks"][run]
    assert _streams(a) == _streams(b)
    assert a["tables_digest"] == b["tables_digest"]
    assert a["logits_digest"] == b["logits_digest"]
    assert a["stats"]["decode_steps"] == b["stats"]["decode_steps"] > 0


@pytest.mark.parametrize("arch", list(RUNS))
def test_no_compressed_leaf_the_reference_splits_is_whole(served, arch):
    """Every compressed leaf that the reference places on the model axis
    (values or indices) is held split on each rank, on the dim the
    placement names (reduction: ``rshards``, output: ``oshards``), and
    every other one whole."""
    s = served[arch]
    specs = _specs_by_name(jax_param_pspecs(s["jtree"], StandIn(RANKS), cfg=s["jcfg"]))
    for rank in s["ranks"]["slab"]:
        held = rank["shards"]
        assert set(held) <= set(specs) and len(held) >= 2
        for name, (rshards, oshards) in held.items():
            values = specs[name][0]
            want = (RANKS if values[-2] == "model" else 1, RANKS if values[-1] == "model" else 1)
            assert (rshards, oshards) == want, name


@pytest.mark.parametrize("arch,run", ALL)
def test_cache_shapes_follow_the_placements(served, arch, run):
    """Every leaf of a rank's cache has the shape that its placement
    (``serving_cache_pspecs``, held to the reference's by
    ``test_torch_sharded``, sanitized for 2 ranks) gives the single-rank
    engine's: a dim placed on ``model`` split over the ranks (a pool's
    pages axis: a rank's share plus its own sink page), every other whole.
    So the RG-LRU state on the split slab holds the rank's columns, SSM
    states their heads, slab K/V and latents their rows, and an odd slab
    is whole on each rank."""
    s = served[arch]
    whole = s["single"][run]["cache_shapes"]
    paged = run != "slab"
    layout = type("Layout", (), {"kind": "paged" if paged else "slab"})()
    meta = {}
    for name, shape in whole.items():
        node = meta
        for part in name.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[name.split("/")[-1]] = torch.empty(shape, device="meta")
    specs = _specs_by_name(serving_cache_pspecs(StandIn(RANKS), meta, layout))
    split = 0
    for rank in s["ranks"][run]:
        assert set(rank["cache_shapes"]) == set(whole)
        for name, shape in whole.items():
            sink = int(paged and name.split("/")[-1] in POOL_LEAVES)
            on = ["model" in (e if isinstance(e, tuple) else (e,)) for e in specs[name]]
            logical = tuple(n - sink if o else n for n, o in zip(shape, on))
            sane = sanitize_spec(specs[name], logical, StandIn(RANKS))
            want = tuple(n // RANKS + sink if e == "model" else n + (sink if o else 0)
                         for n, e, o in zip(logical, sane, on))
            assert rank["cache_shapes"][name] == want, (name, shape, specs[name])
            split += want != shape
    assert (split > 0) == (run != "odd")


@pytest.mark.parametrize("arch,runs", [("recurrentgemma-9b", ("fp", "int8")),
                                       ("starcoder2-3b", ("fp", "int8", "preempting")),
                                       ("deepseek-v2-lite-16b", ("fp", "int8"))])
def test_sharded_pools_take_the_stats_route(served, arch, runs):
    """On a pages-sharded pool decode attention takes the stats form and
    its combine (``shard_map/plain`` on CPU tensors); a slab reports
    ``slab`` and the SSM pool ``none``."""
    s = served[arch]
    for run in runs:
        assert s["ranks"][run][0]["kernel_route"] == "shard_map/plain"
    assert s["ranks"]["slab"][0]["kernel_route"] == "slab"
    assert served["mamba2-2.7b"]["ranks"]["fp"][0]["kernel_route"] == "none"


def test_deepseek_forward_logits_match_the_reference(served):
    """DeepSeek's forward logits on two ranks (MLA projections and MoE
    expert stacks sharded, their partial sums combined in f32) lie within
    1e-4 of the reference forward's over the same compressed tree."""
    s = served["deepseek-v2-lite-16b"]
    for rank in s["ranks"]["slab"]:
        np.testing.assert_allclose(rank["logits"], s["reference_logits"], **LOGIT_TOL)


@pytest.mark.parametrize("run", list(RUNS["deepseek-v2-lite-16b"]))
def test_deepseek_streams_agree_with_the_reference(served, run):
    """DeepSeek's 2-rank streams against the reference engine's on the same
    layout (int8 pages too) wherever the f32 top-2 margin clears
    ``torch_parity.MARGIN``."""
    s = served["deepseek-v2-lite-16b"]
    ours = _streams(s["ranks"][run][0])
    assert all(len(x) == GEN for x in ours)
    for p, a, b in zip(s["prompts"], ours, s["reference"][run]):
        assert_streams_agree(s["tcfg"], s["tree"], p, a, b)


def test_collectives_a_decode_step(served):
    """The collectives a decode step runs, per family (reduced shapes, 4
    layers): gpt2 2 + 8 a layer, 2 fewer (no combine) on a slab the ranks
    do not split; DeepSeek's absorbed MLA 6 a layer on either layout (on
    an odd slab the expanded route: 4, ``w_ukv`` gathered), MoE 6, the
    dense first MLP 3, the embedding 1; Mamba-2
    2 a layer (``w_in``, ``w_out``) + the embedding and the tied
    unembedding; an RG-LRU layer 3 fewer on the split slab than on a pool
    (its gates and GeLU branch give the rank's columns, ungathered); every
    other pool run as many as its slab run."""
    per = {arch: {run: s["ranks"][run][0]["stats"]["collectives_per_decode_step"]
                  for run in RUNS[arch]} for arch, s in served.items()}
    assert per["gpt2-paper"] == {"slab": 2 + 8 * 4, "odd": 2 + 6 * 4}
    assert per["deepseek-v2-lite-16b"] == {"slab": 6 * 4 + 3 + 3 * 6 + 1,
                                           "fp": 6 * 4 + 3 + 3 * 6 + 1,
                                           "int8": 6 * 4 + 3 + 3 * 6 + 1,
                                           "odd": 4 * 4 + 3 + 3 * 6 + 1}
    assert per["mamba2-2.7b"] == {"slab": 2 * 4 + 2, "fp": 2 * 4 + 2}
    rg = per["recurrentgemma-9b"]
    rec = served["recurrentgemma-9b"]["tcfg"].block_kinds().count("rec")
    assert rg["fp"] == rg["int8"] == rg["slab"] + 3 * rec, rg
    assert len(set(per["starcoder2-3b"].values())) == 1, per["starcoder2-3b"]


@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("window", [None, 8])
def test_split_slab_holds_the_slab_rows(window, shards):
    """The ranks of a split slab (``SlabLayout.shards``; a window slab as a
    ring) hold, over their valid rows, exactly the positions the unsplit
    slab (rolled for a window) holds over its valid rows, after a prefill
    and each decode write, lane by lane; a lane outside ``commit`` at a
    full window keeps its rows on both."""
    max_len, lens, lp = 12, [5, 9, 3], 9
    whole = SlabLayout(max_len)
    parts = [SlabLayout(max_len, shards=shards, shard=r) for r in range(shards)]
    entries = {"k": (1,)}
    caches = [lay.alloc((1,), 3, entries, torch.float32, "cpu", window=window)
              for lay in [whole] + parts]
    # an entry's value names its lane and position: 100 * lane + position
    rows = torch.tensor([[100.0 * n + p for p in range(lp)] for n in range(3)])[None, :, :, None]
    lanes, lens_t = torch.arange(3), torch.tensor(lens)
    for lay, c in zip([whole] + parts, caches):
        lay.write_rows(c, {"k": rows}, lanes, lens_t, None, window=window)

    def held(pos):
        s = whole.rows(window)
        live = torch.minimum(pos + 1, torch.tensor(s))
        want = [set(caches[0]["k"][0, n, :live[n], 0].tolist()) for n in range(3)]
        got = [set() for _ in range(3)]
        for lay, c in zip(parts, caches[1:]):
            ok = lay.valid_rows(pos, c["k"].shape[2], window)
            for n in range(3):
                got[n] |= set(c["k"][0, n][ok[n], 0].tolist())
        return want, got

    pos = lens_t.clone()
    for step in range(10):
        commit = torch.tensor([True, step != 6, True])
        x = (100.0 * lanes + pos.float())[:, None]
        for lay, c in zip([whole] + parts, caches):
            lay.write({"k": c["k"][0]}, {"k": x}, pos, None, window=window, commit=commit)
        want, got = held(pos)
        assert got == want, (step, pos.tolist())
        pos = pos + commit.long()
