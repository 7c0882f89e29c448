"""The data axis in the port, held against the JAX package on the CPU.

Serving: one spawn of a ``(2, 2)`` mesh (four gloo ranks,
``launch.serve.serve_jobs``) serves f32 compressed trees at reduced
shapes: gpt2-paper on the slab and on fp, int8 and preempting pools,
DeepSeek-V2-Lite (MLA + MoE), RecurrentGemma-9B (RG-LRU and a window of
16 that the traffic passes) and Mamba2-2.7B on the slab and an fp pool,
each data row decoding its 2 of the 4 lanes; and gpt2-paper with 3 lanes,
which the 2 data rows do not divide, so every row holds them all.  The
streams equal the reference ``DecodeEngine(mesh=None)``'s on the same
layout (token for token, DeepSeek's where the f32 top-2 margin clears
``torch_parity.MARGIN``) and the port's single-rank engine's; the four
ranks hold the same streams, preemptions, host page tables and forward
logits; each cache leaf has the shape its placement gives; a sampled run
draws the single-rank engine's tokens.

Training: the train CLI's run on a ``(2, 1)`` mesh
(``launch.train.train_rank``): byte-identical parameters, one ``t0``, an
f32 gradient within 1e-5 of one process's.  One spawn of a ``(2, 1)``
mesh trains ``SyntheticTask`` with
STEP and 1-bit error feedback in phase 2 (``tests/torch_dp_probe.py``):
the ranks' parameters stay bit-identical and their ``t0`` equal; the
phase-1 averaged gradient is the single-process gradient of the whole
batch within 1e-5 (relative, by global norm); a phase-2 averaged gradient
is, within 1e-6, the mean of the reference's own ``ef_sign_compress``
applied to each rank's gradient and residual (the reference's
``axis_name`` semantics)."""
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import TransformerLM
from repro.optim.compression import CompressionState as JaxCompressionState
from repro.optim.compression import ef_sign_compress as jax_ef_sign_compress
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import SamplingParams as JaxSampling
from repro_torch.distributed.compressed_pspecs import serving_cache_pspecs
from repro_torch.distributed.sharding import axis_sizes, sanitize_spec
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.serve import serve_jobs, serve_rank
from repro_torch.launch.train import train_rank
from repro_torch.models.model import loss_fn
from repro_torch.train.loop import compute_grads
from repro_torch.utils.tree import tree_items, tree_map_with_name, unflatten
from test_torch_compression import StandIn
from torch_dp_probe import BATCH, SWITCH, build, flat, train_task
from torch_parity import assert_streams_agree, configs, port_tree, prompts, to_jax

# 4 lanes of max_len 28 (rows the model ranks split), pages of 4, K = 2;
# 6 prompts of 5 to 20 tokens and 6 new ones (two wait for a lane; the
# longest pass RecurrentGemma's window of 16)
SERVE = dict(max_batch=4, max_len=28, page_size=4, steps_per_dispatch=2, seed=0)
GEN, N_PROMPTS = 6, 6
DATA, MODEL = 2, 2
# staggered lanes: with max_len 24 the 20- and 19-token prompts (lanes 2
# and 3) stop at the cache's end after 4 and 5 tokens, so the last two
# requests decode in lanes 2 and 3 after lanes 0 and 1 are done: the data
# rows' lanes go live and idle at different steps
STAGGER = [np.random.default_rng(300 + i).integers(0, 256, n).tolist()
           for i, n in enumerate((5, 8, 20, 19, 11, 14))]
RUNS = {
    "gpt2-paper": {"slab": {}, "fp": dict(num_pages=28),
                   "int8": dict(num_pages=28, kv_quant=True),
                   "preempting": dict(num_pages=12), "whole": dict(max_batch=3),
                   "sampled": dict(sampling=dict(temperature=0.9, top_k=20)),
                   "staggered": dict(max_len=24, prompts=STAGGER)},
    "deepseek-v2-lite-16b": {"slab": {}, "fp": dict(num_pages=28)},
    "recurrentgemma-9b": {"slab": {}, "fp": dict(num_pages=28)},
    "mamba2-2.7b": {"slab": {}, "fp": dict(num_pages=28)},
}
ALL = [(arch, run) for arch, runs in RUNS.items() for run in runs]
# the runs held to the reference engine (whose draws are its own)
GREEDY = [(arch, run) for arch, run in ALL if run != "sampled"]
POOL_LEAVES = ("k", "v", "ckv", "krope", "k_scale", "v_scale", "ckv_scale", "krope_scale")
# the model group's collectives a decode step (test_torch_sharded_families)
MODEL_COLLECTIVES = {"gpt2-paper": 2 + 8 * 4, "mamba2-2.7b": 2 * 4 + 2,
                     "deepseek-v2-lite-16b": 6 * 4 + 3 + 3 * 6 + 1}


def _streams(rec):
    return [rec["results"][u].tokens for u in sorted(rec["results"])]


@pytest.fixture(scope="module")
def served():
    """Every arch's reduced f32 tree served by the (2, 2) mesh (one spawn, in
    a thread), by the port's single-rank engine and by the reference engine
    (4 threads), run for run."""
    out, jobs, port_trees = {}, [], {}
    for arch, runs in RUNS.items():
        jcfg, _ = configs(arch)
        tcfg, tp = port_tree(arch)
        reqs = prompts(N_PROMPTS, tcfg.vocab, lo=5, step=3)
        port_trees[arch] = tp
        jobs.append(dict(cfg=tcfg, tree=arch, prompts=reqs, sampling=dict(max_new_tokens=GEN),
                         runs=list(runs.values()), engine_kw=SERVE))
        out[arch] = dict(jcfg=jcfg, tcfg=tcfg, jtree=to_jax(tp), tree=tp, prompts=reqs)
    ranks = {}

    def spawn():
        try:
            ranks["out"] = run_ranks(serve_jobs, (jobs,), data=DATA, model=MODEL, device="cpu",
                                     tree=port_trees, log=lambda m: None)
        except BaseException as exc:  # re-raised below
            ranks["error"] = exc

    def reference(s, run):
        run = dict(run)
        reqs = run.pop("prompts", s["prompts"])
        jeng = JaxEngine(TransformerLM(s["jcfg"]), s["jtree"], **{**SERVE, **run})
        uids = [jeng.submit(p, JaxSampling(max_new_tokens=GEN)) for p in reqs]
        jres = jeng.run()
        return [jres[u].tokens for u in uids]

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        for arch, runs in RUNS.items():
            s = out[arch]
            s["single"] = dict(zip(runs, serve_rank(
                None, s["tree"], s["tcfg"], list(runs.values()), s["prompts"],
                dict(max_new_tokens=GEN), SERVE, device="cpu")))
        with ThreadPoolExecutor(4) as ex:
            refs = {(arch, name): ex.submit(reference, out[arch], RUNS[arch][name])
                    for arch, name in GREEDY}
        for (arch, name), ref in refs.items():
            out[arch].setdefault("reference", {})[name] = ref.result()
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    for j, arch in enumerate(RUNS):
        out[arch]["ranks"] = {name: [r[j]["runs"][i] for r in ranks["out"]]
                              for i, name in enumerate(RUNS[arch])}
    return out


@pytest.mark.parametrize("arch,run", GREEDY)
def test_data_axis_gives_the_reference_streams(served, arch, run):
    """Each run's streams on the (2, 2) mesh are the reference engine's on
    the same layout, every request to its budget, or to the cache's end in
    the staggered run (DeepSeek's where the f32 top-2 margin clears the
    tolerance: its top-k routing has near-ties)."""
    s = served[arch]
    ours = _streams(s["ranks"][run][0])
    want = [GEN, GEN, 4, 5, GEN, GEN] if run == "staggered" else [GEN] * N_PROMPTS
    assert [len(x) for x in ours] == want
    if arch == "deepseek-v2-lite-16b":
        for p, a, b in zip(s["prompts"], ours, s["reference"][run]):
            assert_streams_agree(s["tcfg"], s["tree"], p, a, b)
    else:
        assert ours == s["reference"][run]


@pytest.mark.parametrize("arch,run", ALL)
def test_data_axis_gives_one_ranks_streams(served, arch, run):
    """The mesh's streams and preemptions are the port's single-rank
    engine's (the preempting pool preempts on both; sampled streams too:
    a draw is keyed by request and token index, not by lane or rank); a
    rank serves its data row's lanes: 2 of the 4, or all 3 where the rows
    do not divide them."""
    s = served[arch]
    single = s["single"][run]
    for r, rank in enumerate(s["ranks"][run]):
        assert _streams(rank) == _streams(single)
        assert rank["stats"]["preemptions"] == single["stats"]["preemptions"]
        d = r // MODEL
        assert rank["stats"]["lanes"] == ([0, 3] if run == "whole" else [2 * d, 2 * d + 2])
        assert rank["stats"]["mesh"]["shape"] == [DATA, MODEL]
    assert (single["stats"]["preemptions"] > 0) == (run == "preempting")
    if run == "sampled":  # the draws took other tokens than the greedy run's
        assert _streams(single) != _streams(s["single"]["slab"])


@pytest.mark.parametrize("arch,run", ALL)
def test_ranks_agree(served, arch, run):
    """All four ranks hold the same streams, host page tables after every
    step, forward logits and counters; each data row gathered the tokens
    once a prefill batch and once a decode dispatch (none where every row
    holds every lane)."""
    recs = served[arch]["ranks"][run]
    a = recs[0]
    for b in recs[1:]:
        assert _streams(a) == _streams(b)
        for key in ("tables_digest", "logits_digest"):
            assert a[key] == b[key], key
        for key in ("decode_steps", "dispatches", "prefill_batches", "data_gathers",
                    "preemptions", "admitted"):
            assert a["stats"][key] == b["stats"][key], key
    st = a["stats"]
    want = 0 if run == "whole" else st["dispatches"] + st["prefill_batches"]
    assert st["data_gathers"] == want and st["decode_steps"] > 0


@pytest.mark.parametrize("arch", ["gpt2-paper", "deepseek-v2-lite-16b", "mamba2-2.7b"])
def test_collectives_a_decode_step(served, arch):
    """A decode step runs its model group's collectives (as on a (1, 2)
    mesh) and a dispatch of K = 2 steps one gather over the data group."""
    for run, recs in served[arch]["ranks"].items():
        per = recs[0]["stats"]["collectives_per_decode_step"]
        extra = 0 if run == "whole" else 1 / SERVE["steps_per_dispatch"]
        assert per == MODEL_COLLECTIVES[arch] + extra, (run, per)


@pytest.mark.parametrize("arch,run", ALL)
def test_cache_shapes_follow_the_placements(served, arch, run):
    """Every leaf of a rank's cache has the shape that its placement
    (``serving_cache_pspecs`` at (2, 2), sanitized) gives the single-rank
    engine's: lane lengths, states and slab lanes split over the data
    rows (whole with 3 lanes), slab rows, SSM heads and pool pages (plus a
    rank's sink page) over the model ranks, page tables whole."""
    s = served[arch]
    whole = s["single"][run]["cache_shapes"]
    paged = "num_pages" in RUNS[arch][run]
    layout = type("Layout", (), {"kind": "paged" if paged else "slab"})()
    meta = unflatten({name: torch.empty(shape, device="meta") for name, shape in whole.items()})
    mesh = StandIn(DATA, MODEL)
    sizes = axis_sizes(mesh)
    specs = serving_cache_pspecs(mesh, meta, layout)
    lanes_split = 0
    for name, shape in whole.items():
        spec = specs
        for key in name.split("/"):
            spec = spec[key]
        sink = int(paged and name.split("/")[-1] in POOL_LEAVES)
        on = ["model" in (e if isinstance(e, tuple) else (e,)) for e in spec]
        logical = tuple(n - sink if o else n for n, o in zip(shape, on))
        sane = sanitize_spec(spec, logical, mesh)

        def part(n, e):
            k = 1
            for a in (e if isinstance(e, tuple) else (e,)) if e is not None else ():
                k *= sizes[a]
            return n // k

        want = tuple(part(n, e) + (sink if o else 0) for n, e, o in zip(logical, sane, on))
        lanes_split += any(e is not None and "data" in (e if isinstance(e, tuple) else (e,))
                           for e in sane)
        for rank in s["ranks"][run]:
            assert rank["cache_shapes"][name] == want, (name, shape, spec)
        if name.startswith("tables/"):
            assert want == shape
    assert (lanes_split > 0) == (run != "whole")


# -- data-parallel training ---------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """Two ranks of a (2, 1) mesh train SyntheticTask (torch_dp_probe)."""
    return run_ranks(train_task, (), data=2, model=1, device="cpu", log=lambda m: None)


def test_ranks_keep_identical_parameters_and_switch_together(trained):
    """After the run both ranks hold bit-identical parameters and the same
    phase flag and ``t0``, inside AutoSwitch's ``(t_min, t_max + 1]``; the
    averaged gradient was bit-identical on both at every step."""
    a, b = trained
    assert a["digest"] == b["digest"]
    assert a["t0"] == b["t0"] and a["phase2"] and b["phase2"]
    assert SWITCH["t_min"] < a["t0"] <= SWITCH["t_max"] + 1
    for ga, gb in zip(a["avg"], b["avg"]):
        for name in ga:
            np.testing.assert_array_equal(ga[name], gb[name])
    assert [h["loss"] for h in a["history"]] == [h["loss"] for h in b["history"]]


def _rel(a: dict, b: dict) -> float:
    num = np.sqrt(sum(np.sum((a[n] - b[n]) ** 2) for n in b))
    return num / np.sqrt(sum(np.sum(b[n] ** 2) for n in b))


def test_phase1_average_is_the_whole_batch_gradient(trained):
    """Step 0 (phase 1): the average of the ranks' half-batch gradients is
    the single-process gradient of the whole batch within 1e-5 relative."""
    trainer, params, task = build()
    x, y = task.batch(0, BATCH)
    _, _, grads = compute_grads(lambda p, b: (task.loss(p, b["x"], b["y"]), {}),
                                trainer.recipe, params, {"x": x, "y": y}, {}, False)
    assert not trained[0]["enabled"][0]
    assert _rel(trained[0]["avg"][0], flat(grads)) < 1e-5
    trainer.data.close()


def test_phase2_average_is_the_reference_compression_averaged(trained):
    """In phase 2 the averaged gradient is, within 1e-6, the mean over the
    ranks of the reference's ``ef_sign_compress`` of each rank's gradient
    with its residual; the residual is zero up to the switch and nonzero
    after it."""
    a = trained[0]
    steps = [t for t, on in enumerate(a["enabled"]) if on]
    assert steps and steps[0] == a["t0"]
    for t in (steps[0], steps[-1]):
        qs = []
        for r in trained:
            g = {n: jnp.asarray(v) for n, v in r["local"][t].items()}
            res = JaxCompressionState({n: jnp.asarray(v) for n, v in r["residual"][t].items()})
            q, _ = jax_ef_sign_compress(g, res, True)
            qs.append({n: np.asarray(v) for n, v in q.items()})
        for name, got in a["avg"][t].items():
            np.testing.assert_allclose(got, (qs[0][name] + qs[1][name]) / 2, atol=1e-6, rtol=0)
    for r in trained:
        for t, res in enumerate(r["residual"]):
            zero = all(not np.any(v) for v in res.values())
            assert zero == (t <= steps[0]), t
        norms = [h["ef_residual_norm"] for h in r["history"]]
        assert all(n == 0 for n in norms[:steps[0]]) and all(n > 0 for n in norms[steps[0]:])


@pytest.fixture(scope="module")
def cli_trained():
    """``launch.train.train_rank`` on a (2, 1) mesh: the train CLI's run
    (reduced gpt2-paper, 12 steps, batch 4, 1-bit error feedback from the
    forced switch at 6) with the f32 gradient probe of step 0."""
    return run_ranks(train_rank, (CLI_ARGS, {"switch": (2, 5), "grad_probe": True}),
                     data=2, model=1, device="cpu", log=lambda m: None)


CLI_ARGS = ["--device", "cpu", "--steps", "12", "--batch", "4", "--seq", "16",
            "--compress-phase2"]


def test_train_rank_runs_the_cli_data_parallel(cli_trained):
    """Both ranks end with byte-identical parameters and the same ``t0``
    (the forced switch), their exports exactly 2:4; each step all-reduced
    one f32 buffer of every gradient element and the loss; the ranks'
    averaged f32 gradient of step 0 equals on both and lies within 1e-5
    (relative, by global norm) of one process's gradient of the whole
    batch."""
    a, b = cli_trained
    assert a["params_digest"] == b["params_digest"] and a["t0"] == b["t0"] == 6
    assert a["summary"] == b["summary"] and a["summary"]["phase2"]
    assert a["export_off_pattern"] == b["export_off_pattern"] == []
    assert a["probe"]["digest"] == b["probe"]["digest"] and b["probe"]["grad"] is None
    args = launch_train.parse_args(CLI_ARGS)
    run = launch_train.build(args, torch.device("cpu"))
    run.trainer.data.close()
    cfg32 = dataclasses.replace(run.cfg, param_dtype="float32")
    p32 = tree_map_with_name(lambda _, p: p.float(), run.params)
    _, _, grads = compute_grads(lambda p, bb: loss_fn(p, cfg32, bb, chunk=16), run.recipe, p32,
                                {k: torch.as_tensor(v) for k, v in run.batch_fn(0, 4).items()},
                                {}, False)
    one = torch.cat([g.reshape(-1) for _, g in tree_items(grads)]).numpy()
    assert np.linalg.norm(a["probe"]["grad"] - one) <= 1e-5 * np.linalg.norm(one)
    n = sum(p.numel() for _, p in tree_items(p32))
    assert {h["allreduce_bytes"] for h in a["history"]} == {4 * (n + 1)}
    assert [int(h["phase2"]) for h in a["history"]] == [0] * 6 + [1] * 6
