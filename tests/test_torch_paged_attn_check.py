"""The cases of ``kernels/paged_attn_check.py``, on the CPU.

On the card the GQA/MLA body of ``paged_attn`` is held against SHA-256
digests of the first version's outputs on these cases; the digests hold
only while every case's inputs stay the same bytes.  Here: the inputs'
bytes are fixed, every case has its digest, the cases cover what they
claim (dead lanes, a sentinel slot inside a live range, partial last
pages, every form x query type x page type x flush), and the plain
version runs on each."""
import hashlib
import itertools

import pytest
import torch

from repro_torch.kernels import paged_attn_check as check
from repro_torch.kernels.paged_attn import paged_attn

# SHA-256 over every case's operands, in keys() order (computed from the
# generator when the digests were taken)
INPUTS_SHA256 = "f53abea49ad6a41edda328df33bbd1119c1d573336b91a9794082d66e7b1e6f7"


def _operand_bytes(key):
    args, kw = check.operands(key, "cpu")
    tensors = list(args) + [kw[n] for n in sorted(kw) if isinstance(kw[n], torch.Tensor)]
    return b"".join(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
                    for t in tensors if t is not None)


def test_inputs_are_fixed_bytes():
    h = hashlib.sha256()
    for key in check.keys():
        h.update(_operand_bytes(key))
    assert h.hexdigest() == INPUTS_SHA256


def test_every_case_has_a_digest():
    assert list(check.DIGESTS) == check.keys()
    named = [c for c in check.CASES.values() if c.combo is None]
    assert len(check.keys()) == len(named) * 2 * 3 * 2 + check.GRID_SIZE
    assert set(check.keys("gqa")) | set(check.keys("mla")) == set(check.keys())
    assert all(len(d) == 64 and int(d, 16) >= 0 for d in check.DIGESTS.values())


@pytest.mark.parametrize("name", [n for n, c in check.CASES.items() if c.combo is None])
def test_cases_cover_dead_lanes_sentinels_and_partial_pages(name):
    args, kw = check.operands(f"{name}/bf16q/int8p/stats", "cpu")
    tables, lengths = args[-2:]
    ps, num_pages = args[1].shape[1], args[1].shape[0]
    assert (lengths == 0).any()  # a dead lane
    assert bool((lengths % ps != 0).any())  # a partial last page
    if check.CASES[name].holes == "lane4":  # the card tests' unmapped slot in a live range
        assert int(tables[4, 1]) == num_pages and int(lengths[4]) > ps
    for i, ln in enumerate(lengths.tolist()):  # live slots map distinct pages in range
        live = tables[i, :-(-ln // ps)] if ln else tables[i, :0]
        mapped = live[live != num_pages]
        assert len(set(mapped.tolist())) == len(mapped) and bool((mapped < num_pages).all())
    assert kw["k_scale"].dtype == torch.float16 and kw["k_scale"].shape == (num_pages, ps)


@pytest.mark.parametrize("key", [k for k in check.keys() if "64lanes" not in k])
def test_plain_version_runs_every_case(key):
    """The plain version on each case: finite, dead lanes exactly zero (or
    the dead-lane triple)."""
    y = check.run(paged_attn, key, "cpu")
    dead = int(torch.nonzero(check.operands(key, "cpu")[0][-1] == 0)[0])
    if isinstance(y, tuple):
        acc, m, l = y
        assert bool(torch.isfinite(acc).all()) and float(acc[dead].abs().max()) == 0.0
        assert bool((m[dead] == -1e30).all()) and float(l[dead].abs().max()) == 0.0
    else:
        assert bool(torch.isfinite(y.float()).all()) and float(y[dead].abs().max()) == 0.0


def test_grid_covers_forms_types_widths_and_tables():
    """The grid's cases: both forms and every (query type, page type,
    flush); page sizes from 1 to 256 rows, odd ones included; rows that
    are not whole 4-byte words and a Dv other than D; lanes from 2 to 33,
    each case with a dead lane and a full one; sentinel holes."""
    grid = {n: c for n, c in check.CASES.items() if c.combo is not None}
    assert len(grid) == check.GRID_SIZE
    assert {c.form for c in grid.values()} == {"gqa", "mla"}
    assert {c.combo for c in grid.values()} == set(itertools.product(
        check.Q_TYPES, check.PAGE_TYPES, check.FLUSHES))
    sizes = {c.ps for c in grid.values()}
    assert {1, 3, 33, 256} <= sizes
    assert any(c.d % 2 for c in grid.values()) and any(c.d2 % 2 for c in grid.values())
    assert any(c.dv not in (None, c.d) for c in grid.values())
    assert {len(c.lengths) for c in grid.values()} == {2, 3, 4, 8, 33}
    holes = 0
    for name, c in grid.items():
        assert c.lengths[0] == 0 and c.lengths[-1] == c.n_slots * c.ps
        args, _ = check.operands(f"{name}/{'/'.join(c.combo)}", "cpu")
        tables, lengths = args[-2:]
        holes += int((tables == c.pages).sum()) - int(sum(
            c.n_slots - -(-ln // c.ps) for ln in lengths.tolist()))
        assert tuple(lengths.tolist()) == c.lengths
    assert holes > 0  # unmapped slots inside live ranges


def test_launch_entry_follows_the_cases_form():
    """Each case counts under the entry of its case's form (grid names say
    nothing of it), flush and page type."""
    for key in check.keys():
        name, _, pages, flush = key.split("/")
        e = check.launch_entry(key)
        assert ("_mla" in e) == (check.CASES[name].form == "mla")
        assert ("_stats" in e) == (flush == "stats") and e.endswith("_q") == (pages == "int8p")
