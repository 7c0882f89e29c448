"""The serving stream gate (``serving/streams.py``) that ``chip_smoke.py``
holds its slab, paged and mesh routes to: the port's f32 slab and
preempting paged streams of one traffic pass it at the reduced
gpt2-paper width; a stream corrupted where the f32 top-2 margin is over
``MARGIN`` fails it, and so does the paged route served with one
page-table entry off by one."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import forward, init_params
from repro_torch.serving import DecodeEngine, SamplingParams
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.serving.streams import (
    MARGIN,
    StreamGateError,
    check_streams,
    first_difference,
    greedy_gaps,
    stream_differences,
)
from repro_torch.sparse_infer import export_compressed

GEN = 10


def _serve(cfg, comp, prompts, pages):
    """Greedy streams of ``prompts`` over two lanes, on the slab (``pages``
    None) or a pool of ``pages`` 4-token pages; and the preemptions."""
    eng = DecodeEngine(cfg, comp, max_batch=2, max_len=32, seed=0, num_pages=pages,
                       page_size=4, steps_per_dispatch=2, device="cpu")
    uids = [eng.submit(p, SamplingParams(max_new_tokens=GEN)) for p in prompts]
    res = eng.run()
    return [res[u].tokens for u in uids], eng.preemptions


@pytest.fixture(scope="module")
def served():
    """The reduced gpt2-paper's STEP 2:4 export in f32, compressed, and
    its greedy streams of five requests over two lanes on the slab and on
    an undersized pool that preempts."""
    cfg = dataclasses.replace(reduced(get_config("gpt2-paper")), param_dtype="float32")
    recipe = core.make_recipe("step", core.SparsityConfig(default=core.NMSparsity(2, 4)))
    comp, _ = export_compressed(init_params(cfg, seed=0, device="cpu"), recipe)
    prompts = [np.random.default_rng(50 + r).integers(0, cfg.vocab, 6 + 2 * r).tolist()
               for r in range(5)]
    streams = {"slab": _serve(cfg, comp, prompts, None)[0]}
    streams["paged"], preemptions = _serve(cfg, comp, prompts, 9)
    assert preemptions > 0
    return cfg, comp, prompts, streams


def _clear_token(cfg, comp, prompts, streams):
    """``(request, index, runner-up, margin)`` of the first greedy token
    whose f32 top-2 margin is over MARGIN."""
    for r, (p, s) in enumerate(zip(prompts, streams)):
        for j in range(len(s)):
            with torch.inference_mode():
                logits, _ = forward(comp, cfg, torch.tensor([p + s[:j]]))
            top = torch.topk(logits[0, -1].float(), 2)
            margin = float(top.values[0] - top.values[1])
            if margin > MARGIN:
                return r, j, int(top.indices[1]), margin
    raise AssertionError("no greedy token clears the margin")


def test_f32_slab_and_paged_streams_pass_the_gate(served):
    cfg, comp, prompts, streams = served
    agree, total, margins, gap = check_streams(cfg, comp, prompts, streams["slab"],
                                               streams["paged"])
    assert total == 5 * GEN and all(x < MARGIN for x in margins) and gap < MARGIN
    assert agree == total - sum(GEN - first_difference(a, b)
                                for a, b in zip(streams["slab"], streams["paged"]))


def test_a_stream_corrupted_past_the_margin_fails_the_gate(served):
    """Token j of one request swapped for the runner-up where the f32
    top-2 margin is over MARGIN: the gate reads that margin and raises;
    the readings (``stream_differences``) report it without raising."""
    cfg, comp, prompts, streams = served
    slab = streams["slab"]
    r, j, runner_up, margin = _clear_token(cfg, comp, prompts, slab)
    bad = [list(s) for s in slab]
    bad[r][j] = runner_up
    with pytest.raises(StreamGateError, match="margins"):
        check_streams(cfg, comp, prompts, slab, bad)
    agree, total, margins = stream_differences(cfg, comp, prompts, slab, bad)
    assert (agree, total) == (5 * GEN - (GEN - j), 5 * GEN)
    assert margins == pytest.approx([margin], abs=1e-6)


def test_first_difference():
    assert first_difference([1, 2, 3], [1, 2, 3]) == 3
    assert first_difference([1, 2, 3], [1, 5, 3]) == 1


def test_greedy_gaps_read_the_forward_choice(served):
    """A served f32 stream is the forward's greedy choice token by token
    (gap 0 on the CPU); the runner-up put in its place lies its margin
    below the choice."""
    cfg, comp, prompts, streams = served
    slab = streams["slab"]
    gaps = greedy_gaps(cfg, comp, prompts, slab)
    assert [len(g) for g in gaps] == [GEN] * 5
    assert max(max(g) for g in gaps) < 1e-5
    r, j, runner_up, margin = _clear_token(cfg, comp, prompts, slab)
    bad = [list(s) for s in slab]
    bad[r][j] = runner_up
    assert greedy_gaps(cfg, comp, prompts, bad)[r][j] == pytest.approx(margin, abs=1e-6)


@pytest.mark.parametrize("slot", [0, 1])
def test_a_page_table_entry_off_by_one_fails_the_gate(served, monkeypatch, slot):
    """The paged route served with lane 0's page-table entry ``slot``
    pointing at the next page: a fault whose first flips may fall at
    small margins (slot 0's do here), but whose tokens leave the f32
    forward's greedy choice by more than ``MARGIN`` somewhere."""
    cfg, comp, prompts, streams = served
    sync = PagedKVPool.device_tables

    def off_by_one(self):
        tables = sync(self)
        host = int(self._pt["full"][0, slot])
        if host < self.layout.num_pages:  # mapped
            tables["full"][0, slot] = (host + 1) % self.layout.num_pages
        return tables

    monkeypatch.setattr(PagedKVPool, "device_tables", off_by_one)
    bad, _ = _serve(cfg, comp, prompts, 9)
    assert bad != streams["paged"]
    with pytest.raises(StreamGateError):
        check_streams(cfg, comp, prompts, streams["slab"], bad)
