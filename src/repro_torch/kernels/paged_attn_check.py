"""Byte checks of ``paged_attn``'s GQA and MLA body against its first version.

The GQA and MLA forms of ``csrc/paged_attn.cu`` (K2, K2m, their int8 form
K2q and their stats flush K3) were redesigned to keep the first version's
arithmetic exactly, so every output byte of theirs must equal what the
first version wrote for the same inputs.  :data:`DIGESTS` holds the
SHA-256 digests of the first version's outputs (``out``, and under the
stats flush also ``m`` and ``l``) on the inputs :func:`operands` makes,
one per case of :func:`keys`:

- every form x query type x page type x flush at ``chip_smoke.py``'s
  phase-2 shapes, at the shapes of ``tests/test_torch_gpu.py``'s GQA and
  MLA kernel tests (ragged lanes, a dead lane, a sentinel slot inside a
  live range, partial last pages), and at edge shapes: pages of 256 and
  of 33 rows, rows that are not whole 4-byte words, a Dv that is odd or
  no multiple of 4, int8 pages of an odd ps;
- one case each of :data:`GRID_SIZE` shapes drawn from the generator
  below (lanes 2-33 with a dead and a full lane, 1-32 query heads, widths
  1-512, page sizes 1-256, tables of 1-80 slots with sentinel holes, each
  with one query type, page type and flush).

The inputs come from a counter-based generator written out here in numpy
integer arithmetic, so they are the same bytes on any machine and any
numpy or torch version; int8 pages take codes and f16 scales straight
from it.  ``chip_smoke.py`` phase 2 and ``tests/test_torch_gpu.py``
(``-m gpu``) check the kernel against :data:`DIGESTS` on the card.
"""
from __future__ import annotations

import hashlib
import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.paged_attn import entry


class Case(NamedTuple):
    """A shape: ``lengths`` of the first lanes, ``extra`` lanes more of
    random length, ``n_slots`` table slots, ``pages`` in the pool, ``hkv``
    KV heads of ``g`` query heads, widths ``d``, ``d2`` (MLA's second
    stream) and ``dv`` (GQA's V; ``None``: ``d``), ``ps`` rows a page.
    ``holes``: ``"lane4"`` unmaps slot 1 of lane 4, ``"random"`` about one
    slot in 7, ``""`` none.  ``combo``: the one (query type, page type,
    flush) of a grid case; ``None``: all twelve."""

    form: str
    lengths: tuple
    extra: int
    n_slots: int
    pages: int
    hkv: int
    g: int
    d: int
    d2: int
    ps: int
    scale: float
    dv: Optional[int] = None
    holes: str = "lane4"
    combo: Optional[tuple] = None


_P2_GQA = Case("gqa", (97, 33, 0, 70), 0, 7, 40, 12, 1, 64, 0, 16, 64 ** -0.5, holes="")
_P2_MLA = Case("mla", (96, 33, 0, 70), 0, 7, 40, 1, 16, 512, 64, 16, (128 + 64) ** -0.5,
               holes="")


def _test_lengths(ps):
    return (1, 2 * ps + 3, 5 * ps, 0, 3 * ps - 1)


def _gqa_test(hkv, g, d, ps, dv=None):
    return Case("gqa", _test_lengths(ps), 0, 6, 24, hkv, g, d, 0, ps, d ** -0.5, dv)


def _mla_test(g, d, d2, ps, extra):
    return Case("mla", _test_lengths(ps), extra, 6, 24 + 5 * extra, 1, g, d, d2, ps,
                (d + d2) ** -0.5)


Q_TYPES = {"f32q": torch.float32, "bf16q": torch.bfloat16}
PAGE_TYPES = {"f32p": torch.float32, "bf16p": torch.bfloat16, "int8p": torch.int8}
FLUSHES = ("norm", "stats")
GRID_SIZE = 256
# a grid case's pool holds at most this many values a page stream
GRID_MAX_VALUES = 1 << 19


def bits(seed: int, n: int) -> np.ndarray:
    """n pseudo-random 64-bit words (splitmix64 of a counter)."""
    with np.errstate(over="ignore"):
        z = np.arange(n, dtype=np.uint64) + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _grid_case(i: int) -> Case:
    """Grid case ``i``: shapes drawn from :func:`bits`, redrawn until the
    pool stays within ``GRID_MAX_VALUES`` values a stream and the first
    version's f32 staging of one page (its heads a block at most G) fits
    a block's shared memory, as it must for the digest to exist."""
    for attempt in itertools.count():
        w = [int(x) for x in bits(100_000 + 64 * i + attempt, 16)]

        def pick(k, options):
            return options[w[k] % len(options)]

        mla = i % 3 == 2
        ps = pick(0, (1, 2, 3, 4, 5, 8, 16, 16, 32, 33, 64, 128, 256))
        b = pick(1, (2, 3, 4, 8, 33))
        if mla:
            hkv, g = 1, pick(2, (1, 4, 16, 32))
            d, d2 = pick(3, ((16, 8), (128, 32), (512, 64), (256, 32), (6, 3), (20, 5)))
            dv = d
        else:
            hkv, g = pick(2, ((1, 1), (2, 4), (12, 1), (1, 8), (4, 3)))
            d, d2 = pick(3, (16, 64, 128, 256, 5, 24, 63)), 0
            dv = pick(4, (d, d, d + 1, max(1, d // 2)))
        n_slots = pick(5, (1, 3, 7, 40, 80))
        staging = ps * (d + d2 + 2 + (0 if mla else dv) + g) + g * (d + d2 + dv + 3)
        if (b * n_slots + 1) * ps * hkv * max(d, dv) <= GRID_MAX_VALUES and 4 * staging <= 232448:
            break
    cap = n_slots * ps
    middle = bits(200_000 + i, b - 2) % np.uint64(cap + 1)
    lengths = [0] + [int(x) for x in middle] + [cap]  # a dead lane, ..., a full one
    combo = (pick(8, tuple(Q_TYPES)), pick(9, tuple(PAGE_TYPES)), pick(10, FLUSHES))
    return Case("mla" if mla else "gqa", tuple(lengths[:b]), 0, n_slots, b * n_slots + 1, hkv,
                g, d, d2, ps, (d + d2) ** -0.5, dv, "random", combo)


CASES = {
    "gqa_phase2": _P2_GQA,
    "mla_phase2": _P2_MLA,
    "gqa_12x1x64_ps16": _gqa_test(12, 1, 64, 16),
    "gqa_2x3x16_ps4": _gqa_test(2, 3, 16, 4),
    "gqa_4x4x128_ps8": _gqa_test(4, 4, 128, 8),
    "mla_4x16+8_ps4": _mla_test(4, 16, 8, 4, 0),
    "mla_16x512+64_ps16": _mla_test(16, 512, 64, 16, 0),
    "mla_16x512+64_ps16_16lanes": _mla_test(16, 512, 64, 16, 11),
    "mla_16x512+64_ps16_64lanes": _mla_test(16, 512, 64, 16, 59),
    # pages of 256 rows (a stage of one page, a lane's 8 registers a page)
    "gqa_2x1x64_ps256": _gqa_test(2, 1, 64, 256),
    "mla_4x16+8_ps256": _mla_test(4, 16, 8, 256, 0),
    # a page of 33 rows; rows of odd widths (bf16 and int8 rows that are
    # not whole 4-byte words, an odd Dv) at an odd ps (int8 scale planes of
    # 2-byte pieces)
    "gqa_2x3x24_ps33": _gqa_test(2, 3, 24, 33),
    "gqa_2x2x5_dv7_ps5": _gqa_test(2, 2, 5, 5, dv=7),
    "mla_3x6+3_ps3": _mla_test(3, 6, 3, 3, 0),
    "mla_2x10+5_ps7": _mla_test(2, 10, 5, 7, 0),
    **{f"grid{i:03d}": _grid_case(i) for i in range(GRID_SIZE)},
}


def keys(form: str | None = None) -> list[str]:
    """Every case ``shape/query type/page type/flush`` (of one form)."""
    return [f"{name}/{qt}/{pt}/{fl}" for name, case in CASES.items()
            if form in (None, case.form)
            for qt, pt, fl in ([case.combo] if case.combo else
                               itertools.product(Q_TYPES, PAGE_TYPES, FLUSHES))]


def uniform(seed: int, shape, lo: float, hi: float) -> torch.Tensor:
    """f32 values in [lo, hi) on 2^-24 steps."""
    u = (bits(seed, int(np.prod(shape))) >> np.uint64(40)).astype(np.float64) / 2.0 ** 24
    return torch.from_numpy((lo + (hi - lo) * u).astype(np.float32).reshape(shape))


def page_values(seed: int, shape, dtype) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Pages of ``dtype``; int8 pages as codes in [-127, 127] with f16
    scales in [0.004, 0.02) of shape ``shape[:2]``."""
    if dtype != torch.int8:
        return uniform(seed, shape, -2.0, 2.0).to(dtype), None
    codes = (bits(seed, int(np.prod(shape))) >> np.uint64(33)) % np.uint64(255)
    codes = torch.from_numpy(codes.astype(np.int64).reshape(shape) - 127).to(torch.int8)
    return codes, uniform(seed + 1, shape[:2], 0.004, 0.02).half()


def operands(key: str, device) -> tuple[tuple, dict]:
    """``(args, kw)`` of the ``paged_attn`` call of case ``key`` on
    ``device`` (``emit_stats`` included)."""
    name, qt, pt, flush = key.split("/")
    c = CASES[name]
    ps, hkv, dv = c.ps, c.hkv, c.d if c.dv is None else c.dv
    seed = 1 + list(CASES).index(name) * 16
    lengths = list(c.lengths) + [int(x) for x in bits(seed, c.extra) % np.uint64(5 * ps + 1)]
    perm = np.argsort(bits(seed + 1, c.pages), kind="stable").tolist()
    tables = np.full((len(lengths), c.n_slots), c.pages, np.int32)
    for i, ln in enumerate(lengths):
        for pg in range(-(-ln // ps)):
            tables[i, pg] = perm.pop()
    if c.holes == "lane4":  # the card tests: an unmapped slot in a live range
        tables[4, 1] = c.pages
    elif c.holes == "random":
        tables[(bits(seed + 9, tables.size) % np.uint64(7) == 0).reshape(tables.shape)] = c.pages
    b, qtype, ptype = len(lengths), Q_TYPES[qt], PAGE_TYPES[pt]
    q = uniform(seed + 2, (b, hkv, c.g, c.d), -2.0, 2.0).to(qtype)
    kp, ks = page_values(seed + 4, (c.pages, ps, hkv, c.d), ptype)
    second = (uniform(seed + 3, (b, hkv, c.g, c.d2), -2.0, 2.0).to(qtype),
              *page_values(seed + 6, (c.pages, ps, hkv, c.d2), ptype)) if c.form == "mla" else (
        None, *page_values(seed + 6, (c.pages, ps, hkv, dv), ptype))
    q2, p2, s2 = second
    kw = dict(scale=c.scale, emit_stats=flush == "stats", k_scale=ks)
    if c.form == "mla":
        args = (q, kp, None)
        kw.update(q2=q2, k2_pages=p2, v_is_k=True, k2_scale=s2)
    else:
        args = (q, kp, p2)
        kw.update(v_scale=s2)
    args += (torch.from_numpy(tables), torch.tensor(lengths, dtype=torch.int32))
    move = lambda t: None if t is None else t.to(device)  # noqa: E731
    return tuple(move(t) for t in args), {k: move(v) if isinstance(v, torch.Tensor) else v
                                          for k, v in kw.items()}


def launch_entry(key: str) -> str:
    """The launch entry whose count case ``key``'s call adds to."""
    name, _, pages, flush = key.split("/")
    return entry(mla=CASES[name].form == "mla", window=0, stats=flush == "stats",
                 quant=pages == "int8p")


def digest(y) -> str:
    """SHA-256 of the bytes of an output, or of a stats triple in order."""
    h = hashlib.sha256()
    for t in (y if isinstance(y, tuple) else (y,)):
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def run(fn, key: str, device):
    """The output of ``fn`` (``paged_attn``) on case ``key``."""
    args, kw = operands(key, device)
    return fn(*args, **kw)


# SHA-256 of the first version's outputs on every case of keys(): taken on
# the card from the first version of csrc/paged_attn.cu and its
# ``paged_attn`` wrapper, as commit 064ba4a holds them (built with
# dispatch.NVCC_FLAGS), on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit (torch 2.11.0+cu128), with ``run`` and ``digest`` above; two calls
# of each case gave the same bytes.
DIGESTS: dict[str, str] = {
    "gqa_phase2/f32q/f32p/norm":
        "a5610b28a430b22db82ce7dca56179499b343b10e9626433835164e8f22d45c5",
    "gqa_phase2/f32q/f32p/stats":
        "fccef951c2bc0ac51d7a997a1c2980fe46f290323a2ce042cfac63adb22286a4",
    "gqa_phase2/f32q/bf16p/norm":
        "f4b305e8e9f5c09b01b21a2b663c1c8ee02748c086d3e1f3344bea34beee417a",
    "gqa_phase2/f32q/bf16p/stats":
        "1464a01a3bcf6f1305eebb1f736e8ab0043c7fc6900529c397e5dd56b3f21db5",
    "gqa_phase2/f32q/int8p/norm":
        "24b33fb3a3fa9a6e525176a64d917187ef42ce266d3950013818ffaa68124a7d",
    "gqa_phase2/f32q/int8p/stats":
        "0d04981507b227f313475ec9d2dbbba5b0939709295975a86f29f27a1aea468e",
    "gqa_phase2/bf16q/f32p/norm":
        "a9f8ffce438429b03d4aeb03ff56612e5896309db71782110747c4b4b11e45ef",
    "gqa_phase2/bf16q/f32p/stats":
        "41842e13f6c26c04e1816a1d8d484e838515cce866cb0a8c6ab7f9d378662e3d",
    "gqa_phase2/bf16q/bf16p/norm":
        "8a25f9590b18b78d65cb6ad43cd086dcdfb619a6481145c14bb5971aa6db2e48",
    "gqa_phase2/bf16q/bf16p/stats":
        "fd3be47f9ea06b7607ce0e1d9a8f1e106ca3ed92132dec0cf346f4217c71b9a1",
    "gqa_phase2/bf16q/int8p/norm":
        "08769b1cbd09fb708d05e68dabe09a600b9e92d34d741395d7dcf90043165bfb",
    "gqa_phase2/bf16q/int8p/stats":
        "65112e51c8db8b97ce42d9c524ad47f66e676287d6497e674b475dd27decf414",
    "mla_phase2/f32q/f32p/norm":
        "b92ff14f1d2b71bb257394b555eaa036752d88d65f82a6571baff65959601418",
    "mla_phase2/f32q/f32p/stats":
        "eb96e15a70bd6323517c369eade1e7a04b063d380f08d6f5f1320fe69716ac3f",
    "mla_phase2/f32q/bf16p/norm":
        "0d4a140642367ecd1dbe63c283ac90a7b2c00cd7588a5626b494c3defa5b9201",
    "mla_phase2/f32q/bf16p/stats":
        "83ab665664c43b37b6c809d2a080f23c1b71fdbab90bc11c1cb6e66090b2f498",
    "mla_phase2/f32q/int8p/norm":
        "4e3b40de93ef3298b72c928b346af0a08735ebc6ae39aa9d2a14ec82df0ec11e",
    "mla_phase2/f32q/int8p/stats":
        "e6c2ff54ab7f54d606bd0f8df59b47b07193835f40ab405902e6ca8e71115660",
    "mla_phase2/bf16q/f32p/norm":
        "17abf66e07760cc0c32417d0994544b6ad1f9245d2ce056ba6980abbe4a63cd2",
    "mla_phase2/bf16q/f32p/stats":
        "1cd4c03a976651032c22a4d740bf15c376d4ab6c010b9ae1e9cdf33a98efd61e",
    "mla_phase2/bf16q/bf16p/norm":
        "7c3d8850a51b188118df4a9e782b1eae892b2fc236ab850c90ba2da7c91085b6",
    "mla_phase2/bf16q/bf16p/stats":
        "a60a5f4f0f188a970a99f8acca2dda24b12d6754a1b61b4ea65e5c7f934a23d9",
    "mla_phase2/bf16q/int8p/norm":
        "0f57edf48da89dc4b5edade40480fe59a9adf6e8098486d4de6e07dc82adce19",
    "mla_phase2/bf16q/int8p/stats":
        "f2a7a0376d0327bbd02f7771bce60cfa74ae825c74cec570bb5948c5f15d9e4f",
    "gqa_12x1x64_ps16/f32q/f32p/norm":
        "1636d90fb87427f3053b4debd69bf86e131f58da8745ca654ad8d0f04a9a041c",
    "gqa_12x1x64_ps16/f32q/f32p/stats":
        "d0138336ce9a19cb60b6156965d5eebda02e831cf905b5d2c4843d3830e45ac7",
    "gqa_12x1x64_ps16/f32q/bf16p/norm":
        "884aa90032bc15ea7d485c3b66bae3721a4817f873dc37eabf3e05b6f2399db8",
    "gqa_12x1x64_ps16/f32q/bf16p/stats":
        "5db139b873b16aec69db051136d80206427b40f586713fda8abe16f3a2aeeea6",
    "gqa_12x1x64_ps16/f32q/int8p/norm":
        "04206428789376aaa3f0870e3727804fd63b32e238cb450c506d42a09c6451de",
    "gqa_12x1x64_ps16/f32q/int8p/stats":
        "2238f00e1ac263c0cf131be50e706d40c568605a9ec8c712d19713814fe651ed",
    "gqa_12x1x64_ps16/bf16q/f32p/norm":
        "998d10d75fe1cec24f52ebb8dcf49e2cbdb296a2f3732f9c6a0f4a875b2b7423",
    "gqa_12x1x64_ps16/bf16q/f32p/stats":
        "3c5b7447fdb0eddf40472d0d5ab6f2941693d1cf215796592d039aaeb2400110",
    "gqa_12x1x64_ps16/bf16q/bf16p/norm":
        "98f5d368e213bd87d94c1d770179629bc89fed9b293651f3c2626fd5cf45b374",
    "gqa_12x1x64_ps16/bf16q/bf16p/stats":
        "692bcb1c198f23eb7da97beb01db1ba7e97466ccbbef617ce3a0c022473d1212",
    "gqa_12x1x64_ps16/bf16q/int8p/norm":
        "dca852012dabb18203ead01713db7136be90e8d55f72434222abf823c7a5d7a1",
    "gqa_12x1x64_ps16/bf16q/int8p/stats":
        "aaf09a874ca75f528f4bafb90a124938411e6acda8b7816dc4b1354fa4cb0d3b",
    "gqa_2x3x16_ps4/f32q/f32p/norm":
        "5b33850dfce4e86f54587d067da4ddda59d6ec9d84803aa7641e04943cf6b01b",
    "gqa_2x3x16_ps4/f32q/f32p/stats":
        "0e7e9516c9eccbbc6701ca0fa451b0b493070f85d562743d814eee06ee73b2a0",
    "gqa_2x3x16_ps4/f32q/bf16p/norm":
        "5a4597a9364536ad729c99287af868404864fd4f9256791bc0f4efd21b9de4f9",
    "gqa_2x3x16_ps4/f32q/bf16p/stats":
        "345c18a605f9b419f1da72146b44d1daa63c86997b90b4b7c3db3304ea5a434b",
    "gqa_2x3x16_ps4/f32q/int8p/norm":
        "27b4e6604540f58e87dafc874627531a5e7bef824b2dec846fca93d0fffbed0d",
    "gqa_2x3x16_ps4/f32q/int8p/stats":
        "6487ce83fd6b978d2672b054a596b7264b8f372296c3d48dafe5291acdc13e33",
    "gqa_2x3x16_ps4/bf16q/f32p/norm":
        "08150366c0ea8972eb1e6cb4d5091cd4b877b9d8a9783a7ee1dc910994cad4e6",
    "gqa_2x3x16_ps4/bf16q/f32p/stats":
        "2a729334f11f949f9c175d467770269c24dff3872bdf3b676f898680464f70c4",
    "gqa_2x3x16_ps4/bf16q/bf16p/norm":
        "be0207b5ba053d9c1f2e4c90f1c4b044527e44daba11d746690dfa78e61f6f52",
    "gqa_2x3x16_ps4/bf16q/bf16p/stats":
        "0fbc979394af9e51c55efca7cdb0fabaa0c8408924e6932b568a02776068ed05",
    "gqa_2x3x16_ps4/bf16q/int8p/norm":
        "e4aa6c7b003eb95374a3ecdc7709696474ca5ecb63cd155d8791d59fdc929894",
    "gqa_2x3x16_ps4/bf16q/int8p/stats":
        "c1c835d8f963cdecd98df3a18f288a80716416375969f93d6d328c33baeba8e4",
    "gqa_4x4x128_ps8/f32q/f32p/norm":
        "44b9cbee2982c3a047f7360c1b22aaba66f9f4133282aef0aa84d94aca5d3f8a",
    "gqa_4x4x128_ps8/f32q/f32p/stats":
        "5f2fa4180ac553b9728095429ae0c8084ad64e7421a805990b218b17e1d091e3",
    "gqa_4x4x128_ps8/f32q/bf16p/norm":
        "a28afbd18f3c1327e8a77c64ace4479cf596f4a2979253efa3fe78f581c580b2",
    "gqa_4x4x128_ps8/f32q/bf16p/stats":
        "7e8d54f0086018a2e610e2f3a22815ab35b201ebf5121aa5e0620282659a8be1",
    "gqa_4x4x128_ps8/f32q/int8p/norm":
        "65122d7632f89e81c2abefa64c7a502ec322fae06a8c28d5ec7ec40e3663015a",
    "gqa_4x4x128_ps8/f32q/int8p/stats":
        "bf5f1ebeb94c30c4ce06a43a799403d84e1e6b60a0e60a4fee80292953abf76b",
    "gqa_4x4x128_ps8/bf16q/f32p/norm":
        "f42309b37ab6e8ba6d385ea143e7e7a98c49d3bd571563cd2de3013ff15fd784",
    "gqa_4x4x128_ps8/bf16q/f32p/stats":
        "9af2b0b537516abeed3e7800cf5e3a1753648cb854f234ea3bfd6cee303350f2",
    "gqa_4x4x128_ps8/bf16q/bf16p/norm":
        "b1d19eb16ca9f752fca13b2d759b1094d5a9725a5673ddc7b4e7075b8b1a6526",
    "gqa_4x4x128_ps8/bf16q/bf16p/stats":
        "bbd6aa411b1e07e35ad789f3113ccacc717325f6b7691b724580c931fbc94169",
    "gqa_4x4x128_ps8/bf16q/int8p/norm":
        "d410fdd13aec006b67c6bfe680295424eb8bf00d8ece36448c2d0ed0ce6ead6d",
    "gqa_4x4x128_ps8/bf16q/int8p/stats":
        "096e90c8785400b1433efc00d873205b45eb6c5813ddcad39b2176973b1ebddb",
    "mla_4x16+8_ps4/f32q/f32p/norm":
        "1d388981ab9277b9ed91d63603280b8d13ee89c593d9753543c144e1e722ff68",
    "mla_4x16+8_ps4/f32q/f32p/stats":
        "5a378d9ea0c4ecbc0a00ede1ebf9275068f3a44b85c739cf6fcddd7e16e79104",
    "mla_4x16+8_ps4/f32q/bf16p/norm":
        "ca74065f00536644ae4a01dda7054f4a908530549c307d233a60f445b7662db0",
    "mla_4x16+8_ps4/f32q/bf16p/stats":
        "dea30370a1cfa124bff9cf38e21aff5a7f6bf0d31e9fa9664b7a3664858e865f",
    "mla_4x16+8_ps4/f32q/int8p/norm":
        "2c1bd613cf38ecf727d4c305de7e98d0adb8d73fad30486aae13c4a5737eb59e",
    "mla_4x16+8_ps4/f32q/int8p/stats":
        "019949e6df7b763f95d382d0728e4e019895126ebd22033f775f2cba94064dfd",
    "mla_4x16+8_ps4/bf16q/f32p/norm":
        "b2a1bb5b8b7b9eb6cc4eff6af1c083c6704b8e6cbf56dd265a82c3ab6b3d2b43",
    "mla_4x16+8_ps4/bf16q/f32p/stats":
        "f275692f1d9f54e624e4f0b3d3a9de07d5a313707184b3ac9cf600551c75f309",
    "mla_4x16+8_ps4/bf16q/bf16p/norm":
        "f2482fe725b7a369e610a6e829749433f28898b36e0071d5edd140adda484482",
    "mla_4x16+8_ps4/bf16q/bf16p/stats":
        "2ab72b766fb33d76c66fb5839611563cf89ca17d89bb52908a52c5100c89adef",
    "mla_4x16+8_ps4/bf16q/int8p/norm":
        "91d55e57c2c64e598dee2e1ca38c83984cbfc402baddca657cc0d575a6df36e1",
    "mla_4x16+8_ps4/bf16q/int8p/stats":
        "bc79b4fd329ec5e71e8ceb3759f9fd9d87149d2bd7528bedcac96a1af9e6b340",
    "mla_16x512+64_ps16/f32q/f32p/norm":
        "2a0b94e346ed5d6ae21efb6ed6200e1a5d136d789aa383cfbb30c9c07bf365af",
    "mla_16x512+64_ps16/f32q/f32p/stats":
        "e64a2d833e6fbbbbed9880b4298c08710d579a77528480b5cb78009e4c62a01c",
    "mla_16x512+64_ps16/f32q/bf16p/norm":
        "b7091dba44d3078de53719a191f2a8b5c49334198a28f84d0c3dd521c07104ad",
    "mla_16x512+64_ps16/f32q/bf16p/stats":
        "c4abc3f1c021c892a9c8c868bd9439e56bb3c265f663e44aa914451d188f54ea",
    "mla_16x512+64_ps16/f32q/int8p/norm":
        "41a38df799da3321a5d83f9cd78582ea599796a9f1e48c40b9f1c3cd8e98c972",
    "mla_16x512+64_ps16/f32q/int8p/stats":
        "39fba9fdb694dd223c8aa204bbbc3e22d29839e68d7f5099324ce091dedcca2c",
    "mla_16x512+64_ps16/bf16q/f32p/norm":
        "e250c673f352a601533847bda01b1be599f7ec3437016bafb230657585732947",
    "mla_16x512+64_ps16/bf16q/f32p/stats":
        "4b5a0851e20565b2354549b2e0a3d2f2a4de3502d983a5c8eb4d354c82b20af9",
    "mla_16x512+64_ps16/bf16q/bf16p/norm":
        "f9f20695fec65fe59b19d277f23a7f39b6e3fc7820ca59a78f32f41b1e73e42c",
    "mla_16x512+64_ps16/bf16q/bf16p/stats":
        "fefe39fd3c77797a33a698191cfda5452d34c1e6da1b04efe6a5a133463be6fa",
    "mla_16x512+64_ps16/bf16q/int8p/norm":
        "52cf5fc32eebba474cf2fc9bd0c722144069674fda775a0dad4a5892ba8a47e7",
    "mla_16x512+64_ps16/bf16q/int8p/stats":
        "56d91b4f60b15e301adbc87f4b78649a65d6113e2d48c17853137395f130a4b0",
    "mla_16x512+64_ps16_16lanes/f32q/f32p/norm":
        "08d24a19e914b1244244ae074cfb36bf5d54d803f4986779f7670c545ee9d5c9",
    "mla_16x512+64_ps16_16lanes/f32q/f32p/stats":
        "fcb9cd4ef1f91c4a91f10e81af7ff78683f70c7074b51facd3a1e6b1536fa6e2",
    "mla_16x512+64_ps16_16lanes/f32q/bf16p/norm":
        "b7cbc92318c689898230566986029a25345d23d340ad451cda73a69ff3472215",
    "mla_16x512+64_ps16_16lanes/f32q/bf16p/stats":
        "7a06910a3ffaf3342ff4b9fdd01eb29b48d08fabc7e9189c56827feda82d759a",
    "mla_16x512+64_ps16_16lanes/f32q/int8p/norm":
        "0a3d26f029805761162f478b446fc1bbb8ec0fb3c373736b0dd03c62ef3c1b35",
    "mla_16x512+64_ps16_16lanes/f32q/int8p/stats":
        "08af2f37853037edf4592f4997ec418b337178c762ba82bb763afedb9fa3f6cd",
    "mla_16x512+64_ps16_16lanes/bf16q/f32p/norm":
        "f676d7640a37a0f4981a84e8cf978757fd58798529bfde861e2592d2679c1920",
    "mla_16x512+64_ps16_16lanes/bf16q/f32p/stats":
        "b30ba7f13119170c869773a6cf0cfcfddc32c01407ff72e25e6d5ee510a0b47f",
    "mla_16x512+64_ps16_16lanes/bf16q/bf16p/norm":
        "384e4684b9ba68ab0631ab06345e4791395eff4a47a09e6504eb0daa64f20a33",
    "mla_16x512+64_ps16_16lanes/bf16q/bf16p/stats":
        "24ba10771febbdb94e80847c182b9fbb7baf7e1c304a3b029f2208762f1a84f7",
    "mla_16x512+64_ps16_16lanes/bf16q/int8p/norm":
        "9616d9e603f057ee885b5212dde7406d4375059a09343b0b8f7e5271aba196e1",
    "mla_16x512+64_ps16_16lanes/bf16q/int8p/stats":
        "c3f49889a4e1fe8a17ca1e1c22c67dcf8f641fe2a9fbefbfb8f6549e68ab28b0",
    "mla_16x512+64_ps16_64lanes/f32q/f32p/norm":
        "4b7569c4c58075aafb698e78b223f52a257d221d6173cca52cdb61d6efa6bf92",
    "mla_16x512+64_ps16_64lanes/f32q/f32p/stats":
        "ae176688a694b5ac80806bb09399e5cecfbba71a0dc8e8fdc75662a1ea811fde",
    "mla_16x512+64_ps16_64lanes/f32q/bf16p/norm":
        "324af3a189b8eca1c9e4603d1f81f73a1b497dee1e688323ba90d4fd0ade9af8",
    "mla_16x512+64_ps16_64lanes/f32q/bf16p/stats":
        "53c748a059b2982000ced2bc7611c3e46ccbe265032c7594680b27aa4c0450c4",
    "mla_16x512+64_ps16_64lanes/f32q/int8p/norm":
        "257a1eb89c016cc69f1df50f645f5e486f178eca6edc59e2f9f036322165affd",
    "mla_16x512+64_ps16_64lanes/f32q/int8p/stats":
        "e527dd9550830cd931b59eb2956d54246d18ae0dce836d7c1c69a20482136a3f",
    "mla_16x512+64_ps16_64lanes/bf16q/f32p/norm":
        "336fae2ed57e4499068291173779d9d4a3b88e5e557d23e7d50a3732940c1ae6",
    "mla_16x512+64_ps16_64lanes/bf16q/f32p/stats":
        "f529f8f50a4ed5e55d528e1cd4133c10a7b233994a499e1fced6fbfa23435840",
    "mla_16x512+64_ps16_64lanes/bf16q/bf16p/norm":
        "585db6cd8ced00cfe650b5d43262e74dade92c83fa2994408582113c8c628c01",
    "mla_16x512+64_ps16_64lanes/bf16q/bf16p/stats":
        "df639be5b2b2599fba1eb72ab593e382f980e98f5c2e8b58fe41c64610bbe51b",
    "mla_16x512+64_ps16_64lanes/bf16q/int8p/norm":
        "a89e8b5d8821a35d65f0ae4708294569c894e3c12c803fbea0dcae9a09cc3b2d",
    "mla_16x512+64_ps16_64lanes/bf16q/int8p/stats":
        "2370e90708abb0ae131f34b0776a9e63d40f7cac053391aa797f97e98e24d0ee",
    "gqa_2x1x64_ps256/f32q/f32p/norm":
        "04682a8afbe0d0743e05537c5f31b3676406209d13f62976eb734038c4be6d67",
    "gqa_2x1x64_ps256/f32q/f32p/stats":
        "5ee806f9a148af4394b8584144b529041a2944806b755e49b5f42c27e2193e19",
    "gqa_2x1x64_ps256/f32q/bf16p/norm":
        "305f2f7706c6a156e04349213b3e7d191bd37c6eb84a811f1a38e63af2ecd89a",
    "gqa_2x1x64_ps256/f32q/bf16p/stats":
        "160d9ad31ab31a20b370825bf513479b336bcc761570edf4d3ed6f4f2c93c1b4",
    "gqa_2x1x64_ps256/f32q/int8p/norm":
        "3c0ce709d240837b43238f1ee6a6a9522b03fee592796887475ca61bd3b59b68",
    "gqa_2x1x64_ps256/f32q/int8p/stats":
        "aa561933006c035865fa6959b5a9238324aa8f61ebf1e6621264a51ae7d500e5",
    "gqa_2x1x64_ps256/bf16q/f32p/norm":
        "21ec15dba8bbc405e7d70078dc18c68bd115135c4b8d60e2a3105b42abbcbc71",
    "gqa_2x1x64_ps256/bf16q/f32p/stats":
        "c5bb97102e8a3c660f4c334baf0446f4f4b817ec00fac5c81f7c6cd6d41d09f7",
    "gqa_2x1x64_ps256/bf16q/bf16p/norm":
        "c25c7b3b44affb4ac808b1a315b848521978e4ff2db1d717cb4712209df0c2a3",
    "gqa_2x1x64_ps256/bf16q/bf16p/stats":
        "85cd1288a4ecdd6e527acf552bcfbe2cda627a816fe7cff29fd598a8921fe1c7",
    "gqa_2x1x64_ps256/bf16q/int8p/norm":
        "290c9b56751db4ebafc60e4003eb8c31019a06b9899907af61eef057c744719b",
    "gqa_2x1x64_ps256/bf16q/int8p/stats":
        "20c065bfacfcd7713fc18ad85c4cfa72b2c5a7ed1646fb99b8690910b3775e5c",
    "mla_4x16+8_ps256/f32q/f32p/norm":
        "51929d83945a02ed17b497a43b6de0f3e1e0ba10922b5aae03c6a55a60ba4961",
    "mla_4x16+8_ps256/f32q/f32p/stats":
        "6bb4f9c90e59e2d54b38a3e7769828c342763e5355c88e93be01be1266eec411",
    "mla_4x16+8_ps256/f32q/bf16p/norm":
        "d05db74309d166b4d123ba56a243c2f55da27d99c61bdad1b170d0f89e6e2316",
    "mla_4x16+8_ps256/f32q/bf16p/stats":
        "f3afd6133e8e90145aab136ee13029c5d00db1f4a5cb79dbbfcacd5d47ab9acb",
    "mla_4x16+8_ps256/f32q/int8p/norm":
        "faafe26b0c59a46ebb6aa5fd53f488ae7bcfffa0e6b79397dbbb075920a66cf5",
    "mla_4x16+8_ps256/f32q/int8p/stats":
        "30996f3f5d6d75bf84da6170c11252884092472618f2db3f88533fea4687c978",
    "mla_4x16+8_ps256/bf16q/f32p/norm":
        "1851cefc7d58791541ea7cc8561ef33ad2e8a36bd5d259e58203a56f6f5b3d9a",
    "mla_4x16+8_ps256/bf16q/f32p/stats":
        "4f8cc8d7f3ec192a4f838b071358baa032447c021e2197bf5c5761f06ad393bd",
    "mla_4x16+8_ps256/bf16q/bf16p/norm":
        "a183c47446e224877c8609d08b7f050864341cf7a260bc8292341c519bda0eb5",
    "mla_4x16+8_ps256/bf16q/bf16p/stats":
        "33d4ab645d883b7fd6560cca4ea5d0d5f3c5efd9298d9615684e39c62c662085",
    "mla_4x16+8_ps256/bf16q/int8p/norm":
        "c1b27be92bb9b64a9aafd9321b1c03e737255315ff179d633da83da9f5876b02",
    "mla_4x16+8_ps256/bf16q/int8p/stats":
        "91d9ffb04b43c6a6214cd5b8663cf37c85a9a9d10cb77f9e6fdc9f23526eda24",
    "gqa_2x3x24_ps33/f32q/f32p/norm":
        "fff872ac954adbf052ae30f53b7b7b1641878307e8ed2736e8579a470081cfdf",
    "gqa_2x3x24_ps33/f32q/f32p/stats":
        "0c84cb3e7d5c1ca127714cacc2c951760776575f7a058c99eaf2bd7a7fa8190d",
    "gqa_2x3x24_ps33/f32q/bf16p/norm":
        "ac139d8abebfdf6ead6827cb145209f87604e2e51f4a90a389bbba1a288d49a5",
    "gqa_2x3x24_ps33/f32q/bf16p/stats":
        "b5a99adbea1723fbc229ed1f566f3300386ae6ce977e0c670d8a5863764881f1",
    "gqa_2x3x24_ps33/f32q/int8p/norm":
        "2120c0bfb54c39d761065313819c87f630db3feb68f8d2cc844738d017a30842",
    "gqa_2x3x24_ps33/f32q/int8p/stats":
        "b07f5750f673303d4e44435692aa1666f54ea3bc6dae6310eed36918d0554039",
    "gqa_2x3x24_ps33/bf16q/f32p/norm":
        "af77788dfa05ffa1a2f2d648e60e6a9da62ec759dc4798cf9c7af974ffa72d43",
    "gqa_2x3x24_ps33/bf16q/f32p/stats":
        "34eaf9f3995bf03eb1b545b82bb0f66a1010fec14c3eb40f95bb688e563ee638",
    "gqa_2x3x24_ps33/bf16q/bf16p/norm":
        "52a465fddacd77bda108b3a5eef4632b597807dc02eeb6037dfe0f659aedb988",
    "gqa_2x3x24_ps33/bf16q/bf16p/stats":
        "64d3ba969c385b2d5ff7d8a2ef4ec5f5991959ff1c39d5fc773f0d22a995fba1",
    "gqa_2x3x24_ps33/bf16q/int8p/norm":
        "1827540492a2369e95acf1d9b9c49414d59d9a6282de1efab15055f50611a042",
    "gqa_2x3x24_ps33/bf16q/int8p/stats":
        "04c6c268fe1b7f41fe0224ca4d5dbbe36c3d1a6ac3f809e8ac0c50059a73007e",
    "gqa_2x2x5_dv7_ps5/f32q/f32p/norm":
        "249b7c366f2656fdc666e6ca8fabb75869a21917b5ef65612b57185be731988c",
    "gqa_2x2x5_dv7_ps5/f32q/f32p/stats":
        "110aed67917f50a4d935b44c882e8a1beeb16de1effa79c861858edc6b44d4ef",
    "gqa_2x2x5_dv7_ps5/f32q/bf16p/norm":
        "aefeaf6cff9c85d090fe99363dcdddb9a181f5b82aeb6edca08f7faefb8cf495",
    "gqa_2x2x5_dv7_ps5/f32q/bf16p/stats":
        "da40ad0b58a035f751f8e8084127cee877a6245540cb501086602c34b1841c53",
    "gqa_2x2x5_dv7_ps5/f32q/int8p/norm":
        "949c015cec71ead032e29a5530a59394cd6a273c562e81d21e9dfebaefec03bd",
    "gqa_2x2x5_dv7_ps5/f32q/int8p/stats":
        "bbd3d714da6f7dc32e9f6bacc903740933f0faf276d915272d2ecc65655902e6",
    "gqa_2x2x5_dv7_ps5/bf16q/f32p/norm":
        "b5f8e244d4a56914e5c8b1909b6778720ae30ff1d94d3cf26b4c202289999685",
    "gqa_2x2x5_dv7_ps5/bf16q/f32p/stats":
        "74ad444fb9c1174a7451a1635351c2fda90502dd7a0c71e3778af4816c6d87cb",
    "gqa_2x2x5_dv7_ps5/bf16q/bf16p/norm":
        "7e47b9ffc7eb9122106b64677ee36aedc5e166a100a7ccc888e6a8111dc9c796",
    "gqa_2x2x5_dv7_ps5/bf16q/bf16p/stats":
        "de0b16d3dc54ccd2497af3f5682733074f8d1db7019c7f12d84f6cdcfecf45d8",
    "gqa_2x2x5_dv7_ps5/bf16q/int8p/norm":
        "85a6412571033d9bd54ee25254a6d1d21c0eddcd8a059d9a315b7ab15345adf1",
    "gqa_2x2x5_dv7_ps5/bf16q/int8p/stats":
        "d2414cb8fc1548f3a11259eedf4e0f611e5fc8006f7fc46e42f9a362ec779e1f",
    "mla_3x6+3_ps3/f32q/f32p/norm":
        "3146631e4a34bf96ff6ac6f725ef9818d7f50a6622308df3668e04223d2e3422",
    "mla_3x6+3_ps3/f32q/f32p/stats":
        "e03efb2dd0346c09dbdf8d643d89fa7bf28ac285629b03cb9842940ba0c6365d",
    "mla_3x6+3_ps3/f32q/bf16p/norm":
        "c2f291bd2acf25017baac2485948a837d507bab2991cf3c890e026e13d5b896a",
    "mla_3x6+3_ps3/f32q/bf16p/stats":
        "d4fb415cf72dbfeb76c52697d0bf0b4ccf4f9baa5119d4a748ee26036db5c296",
    "mla_3x6+3_ps3/f32q/int8p/norm":
        "eb3e0668ad37c5aa110c8e93d1ab0a58728909d0143df608dd514818bc3a676e",
    "mla_3x6+3_ps3/f32q/int8p/stats":
        "e5814afbcb26ac375703ef8b689074d9dd71910916528f7fa3467ec92b942af2",
    "mla_3x6+3_ps3/bf16q/f32p/norm":
        "db608bd229cb71adefd5d89ba9810bb98ad9a4ee5e7f6a732c0c642be51d13be",
    "mla_3x6+3_ps3/bf16q/f32p/stats":
        "f61967b2371f8f2fd1f06e2662e8f415177e5b5f1327fe3b80f437c45459bffb",
    "mla_3x6+3_ps3/bf16q/bf16p/norm":
        "555bacf9ad63729dd080af925aad986b467ee696cde485216d2b7dc4df3ce872",
    "mla_3x6+3_ps3/bf16q/bf16p/stats":
        "684abf4b21ce32ba80b7899c4d15bb7c9222bc84b255183c69814ef1591c930e",
    "mla_3x6+3_ps3/bf16q/int8p/norm":
        "6b8b02e304ddb120657b134b01823a660597ddb8a6bbe9ca93b7c8d0c2fcb25b",
    "mla_3x6+3_ps3/bf16q/int8p/stats":
        "805f4160e93036dd36d06ec2948103603da8cac14f044fbf75c1d8c8375b477f",
    "mla_2x10+5_ps7/f32q/f32p/norm":
        "7894401777819f3f64cb1cb2da6bf719a4f0517c41b2dc1b2c1e1a259f5b85da",
    "mla_2x10+5_ps7/f32q/f32p/stats":
        "da1106dce6d20fc10a8c0e84a52d7d81f7b6f1ef2aff5b22a4e988d6e7b78703",
    "mla_2x10+5_ps7/f32q/bf16p/norm":
        "17f55b685616ae10f335be215fd7292a2068896aa6d0629899da913e610e7da7",
    "mla_2x10+5_ps7/f32q/bf16p/stats":
        "61eb0af2abe30d3287b4b581a4c462de346aa06114fa750a38e874bed0a8241a",
    "mla_2x10+5_ps7/f32q/int8p/norm":
        "e249a6e5fbea039835ec35b1547a3cde4fd92b877a210d975d0ecf08edcf555a",
    "mla_2x10+5_ps7/f32q/int8p/stats":
        "a0631c11c2769757d2cb74a31fb7e7812af62d822e65c2f870db4b5a1a226a01",
    "mla_2x10+5_ps7/bf16q/f32p/norm":
        "d4e8b3b59fe56348279c373a3c17cfab6116ca456f4db69bb45af102d036f42b",
    "mla_2x10+5_ps7/bf16q/f32p/stats":
        "d74264221b2acb2ff0c56282463e2179be0c53bcc55d4a2f989da7d3a1b6943d",
    "mla_2x10+5_ps7/bf16q/bf16p/norm":
        "5434ab72ab53f72061faea284b28d8a997586f13e91daa707a165962b7f6156e",
    "mla_2x10+5_ps7/bf16q/bf16p/stats":
        "bfe80d7af41ac943ef96fef472e8fd674333da674f1782fca0c093a2992f2375",
    "mla_2x10+5_ps7/bf16q/int8p/norm":
        "29b0056fdf93fdc4328c7b2350998243b3f3114081531ad56a4cc4a243c9bc46",
    "mla_2x10+5_ps7/bf16q/int8p/stats":
        "c50d04404bfe0a11bb91640c937ba9ffe7a4b185071edfdc4504461424d65f2f",
    "grid000/bf16q/bf16p/norm":
        "42f18335b46dde59d5991785e87f8cc9883b6ce1d1bcf1fdcdfce3008bfae6f4",
    "grid001/f32q/int8p/norm":
        "0b66ca70ddee2b092bde19f797300c764602851cf00d3479864e0e863dbea02a",
    "grid002/bf16q/f32p/stats":
        "75373406bd65913ab7beeffb9539aa4fdab9e2335e5c8ef56616078cfdb738f7",
    "grid003/bf16q/f32p/stats":
        "139fd66b23bb37ee1832bbc308badd53427abab1242e5e230e38aef362c3e25d",
    "grid004/f32q/int8p/norm":
        "ed96a4aa5ea0ad25ca3f96020263b9b94e0cbc3d843a15a072ad512e8250644b",
    "grid005/bf16q/bf16p/norm":
        "19abeec78cb5fa9eea56656b6d87b3ad3abc916d5c5e3fde3fb2b301f95b7087",
    "grid006/bf16q/bf16p/stats":
        "f5716d3342343408e0b92f2052a0a34df2849cb531a60bb06734b956aba4ab8c",
    "grid007/bf16q/int8p/stats":
        "e0bbe5872fb781439107fccaca4944473f296c3c6468a53ff214a7e19f9412de",
    "grid008/bf16q/bf16p/stats":
        "814b70836be155e88e4f30d4da49c723ee40ba6ccbed228c2c541f146f1609b7",
    "grid009/bf16q/int8p/stats":
        "6ed5ec48066dbe7c439e8b0c10d9dc576493b05686c530137b912449d95e403b",
    "grid010/bf16q/f32p/norm":
        "8e16909e570fb3d9dad1dca65dc4ab3135a9c4152a3b048ad165c2a6a74b797c",
    "grid011/bf16q/bf16p/stats":
        "a65f8d344b948a1b21f978feb2d422cc55777c3a3438dc7de525000a15a674ff",
    "grid012/bf16q/bf16p/norm":
        "4bd6d759b1ea10973bdd5f2933f274d936700bdbaac03c06bf09455fb46e8867",
    "grid013/bf16q/bf16p/norm":
        "024078ba0ffc48d68e8e8fc38f58ee159f159c21845254fb0932644adecd2464",
    "grid014/f32q/bf16p/stats":
        "5bd24e4f3f60e56a94ad407d598215a32930d0862bd38f92229527bcdd969ba9",
    "grid015/f32q/f32p/stats":
        "c089a2c7fb63e5c9b9aba6e6ae3f898a14f6b11ccf6fe9bbf904a8e091485599",
    "grid016/f32q/bf16p/stats":
        "95f6a6de4dd50ef0e76a20c884d14155f85dbfbc5989fad5da44c32e3c46583e",
    "grid017/bf16q/bf16p/norm":
        "aa8638656a5a58fb90f46c4d336a0141b6cead81ac2e0d14dcc957b90adc8c59",
    "grid018/f32q/f32p/norm":
        "76ee18dbace15b8f59cadc5101eaf1f17e4e8ac5f9a9aaa1a08c573860a3bc14",
    "grid019/bf16q/int8p/stats":
        "f44b8b632cb2013caef5cd43209f28400be6deaa0caaf1098c20642cc6d9170e",
    "grid020/bf16q/f32p/norm":
        "cbfb3bb48a4eb0068c390ba36441e508808d9382e5e8292b17eafb882fb210a2",
    "grid021/bf16q/int8p/stats":
        "726c85653af5484b1e72bd6f5992519f7debf892dd27c8f8410c5a5c3b5ffc32",
    "grid022/bf16q/int8p/stats":
        "328836842de593d1f0cdb46aab2985b84bdc70e1c470f96c74bab925e92797b1",
    "grid023/f32q/int8p/norm":
        "f8fca68e9f1cbb5e5ed744191fc7107501d5b028461241811a559b851a7bc2da",
    "grid024/bf16q/int8p/norm":
        "dc35e3fa8ee2a3251f63333cd175b34445cf16eae05b63d3da3110d487ee56fb",
    "grid025/bf16q/bf16p/norm":
        "dc0282c9a31056d7bf4b1ea53cd4c36449ad5a6909a80687fa6394a2f3277597",
    "grid026/f32q/bf16p/norm":
        "3f352e2de9f38695ac99abf5b81a5e7e4169291e79b3af03ce2a487359b60947",
    "grid027/f32q/bf16p/stats":
        "170bdc19c8eb67fef62a67c9e50b6eb715678a39d0c3c3b63edcf15d989cf1ad",
    "grid028/f32q/int8p/stats":
        "698eb2217e239161f08f0416c5e613f66d4401ef3ba0a4cc0e504a64cdfb4c24",
    "grid029/f32q/f32p/norm":
        "bc0f6ac0c3fde12d8aa3d1f59e20b6ef11ccfb30d35bd25eb3defebeb43a50fe",
    "grid030/bf16q/f32p/norm":
        "e12ed79eedd558789e8e8eb1a50e9e157005695de586e70b0dd347841c5f48b6",
    "grid031/f32q/f32p/stats":
        "cac92180e70ffa07d737ad05dabf7fad2e8868e21c70df87bb8650bce5410ef9",
    "grid032/f32q/int8p/stats":
        "ba915262035eaa2cfa3b627d4bbf45888a68cc6b2eaf0141ae8ae35199f955d7",
    "grid033/f32q/int8p/norm":
        "171508939ac20525d2001490e254202fa4d6a18e063e71bf972decb3bade85e2",
    "grid034/bf16q/f32p/norm":
        "88e0e12cfc1d07e92993199c3184bc610a1be86fb01db29e8e8698152d753506",
    "grid035/bf16q/bf16p/stats":
        "15c6893e0c524e35008d8ff4841cc621df5e79bae32058b397f55a75edb1d2fa",
    "grid036/f32q/int8p/stats":
        "d5183b53dcf81ad114174a81b87d9a36952175402253f6674ed8909abe733d0f",
    "grid037/f32q/f32p/stats":
        "0a350aee75cb0d83ad6a9f858cfbfb1b53c57755e7dc108fecee90f45f13a3ba",
    "grid038/bf16q/int8p/stats":
        "ec642721d697f7233868abaf10bb06e54e3465daf2d24e31026be6e79f4e2d83",
    "grid039/f32q/int8p/stats":
        "b9edc96ef56e35661bf153f1565a47aaa48a631a79d573458969e83224d42ca1",
    "grid040/f32q/f32p/stats":
        "d66c3628fe2fc5ea5ce2774bf57aced0328a932869a3f238841c5b6f0d12a409",
    "grid041/bf16q/bf16p/norm":
        "10206e839958734d1ba2e093cc281413d953c45ee4f6ebba2207c172a551fb18",
    "grid042/bf16q/f32p/norm":
        "9f2f5aed2cf4d6f709cf4afb86117a89b5a4b1d13875a6f274aedcb91ea1ca55",
    "grid043/bf16q/f32p/stats":
        "c112f531d95538674ab476cf5dbf24d7ddaeda257caccf2316a079ae35d9204d",
    "grid044/f32q/bf16p/stats":
        "bde0f8c6da9ac7f589a208fce0047791a1175fe541b932f22d5c6964944666d6",
    "grid045/bf16q/f32p/stats":
        "ba73ec1c1b59595b04c6f0e8836019ab28a355c53423939733059f77adfe156d",
    "grid046/f32q/f32p/norm":
        "15935a0202fa3a15a86b5e496150998d4cc0122920829543cdcaf69ecfa233b4",
    "grid047/f32q/bf16p/norm":
        "72839acdd30286b7fd7f61903e6167362949b3cc88c38cc10f023b20e023f412",
    "grid048/bf16q/f32p/stats":
        "662709834d734601431abb0dbac24e75d755bb8518719886fc8dfe7e0acbd0a1",
    "grid049/f32q/int8p/stats":
        "efcfa9b607238a0eae9e6e4d1015e7e1d514bf325afe34610f47f94b94ae3c92",
    "grid050/bf16q/int8p/stats":
        "64c33f68c9871d3e0eac177e8fb8308b256915fcefccb12c1248895cdbdfdd25",
    "grid051/f32q/int8p/stats":
        "437ebeab3ce87000efa18ad5a26f43d8af7aaa4c359eef453b5db0ca9f6bae49",
    "grid052/f32q/int8p/stats":
        "27373637d02e2b2abafdbfe34fb4ee7fd6d447603032d5d9fcbb7aaff82bc8d8",
    "grid053/bf16q/bf16p/norm":
        "efb78b47874f3882df883a5c6db5e915ab2aba7cb295f04c2da42ba2c758829e",
    "grid054/bf16q/int8p/stats":
        "fb06d58dec5e0f495f74b0892176ebbe34fe7833c12931f106334073044422f1",
    "grid055/f32q/int8p/norm":
        "1fe1af4a3bd7c54977f3e67d8ff4aa9d4fe873cc40ee5168d1e7a43d12ec4ae0",
    "grid056/f32q/f32p/norm":
        "9234ec1eff55fa0900f9599de26daa97dffce2c965b80cd14d11da2ff300f00d",
    "grid057/f32q/f32p/stats":
        "cad5d74e271afd3cc8beb0b1faf674af39602e769e0cbb87a1079c067cba2986",
    "grid058/bf16q/int8p/stats":
        "22ed36391f17db75d75f8486e612614edffcf72787f4be4f23aa4543518f7ee4",
    "grid059/f32q/bf16p/stats":
        "f6cbb8ee239b72bc199bf64e94749e0b0156ee0808d3efee7bc2710c577597da",
    "grid060/bf16q/int8p/stats":
        "bcfc690ab13d7c6484b2cf67280067737bff700b32fb01c828e2e763f69a7b0c",
    "grid061/bf16q/bf16p/stats":
        "6fd6aadff48c86125b3f88110f46d06b5a6b0fe1f8ba817e0d996cabbfe21256",
    "grid062/bf16q/f32p/norm":
        "79d0b6b4d9ee2ab1803ebae20bfa90a0157e6278c42d26935a93607546ffa1b6",
    "grid063/f32q/int8p/stats":
        "1044b7f780d9fe001a88d3a627c16c142054df92f37b76f7d06eb671bdff57d1",
    "grid064/bf16q/int8p/stats":
        "17224ec7019a3ca5ca8fa232f03d03ddfd150086ae7bde5ae6509b5b66e339f2",
    "grid065/bf16q/bf16p/stats":
        "a7dc19f03ac763a2e335c03874a2765f6f5083540b796ba726d53ccca136414e",
    "grid066/f32q/bf16p/stats":
        "8c204207e2bbe3b7ad05755262705f8e6a7d155e4f0f311ea7e960d4e838f203",
    "grid067/f32q/f32p/stats":
        "820fd7a40bd9bbdd13bddc1706ae5c79462461004a63fe1309ff767b0c153dfa",
    "grid068/f32q/f32p/stats":
        "31a480912dfbac9c2270462a0c5750932e0f76c2e6d037bc66b3ce2c02a0067d",
    "grid069/f32q/bf16p/stats":
        "1dd29004f1c305ca67bb913ccfc5ed9be3a48bd554ef7e7e952cb349eed6ba96",
    "grid070/bf16q/f32p/norm":
        "31ee9010a4f80c6b35394f4a506dba12cf47fa23fc0adfb9da61889b1238d3c0",
    "grid071/bf16q/int8p/stats":
        "5d4f2f1cf2ec97afc79bdebb2904d89bb090262e848de8a8d411649e8adb209c",
    "grid072/bf16q/f32p/stats":
        "16082c6b27a39d84379cc289d09d2ee66901c38e24ef249ca3e38b15d4c01838",
    "grid073/bf16q/int8p/stats":
        "c754601b199ec18fbb245e97ec0d113944b2f7233bdec0d431bdd6c6d9eaa9b6",
    "grid074/f32q/f32p/stats":
        "fb42d88b5d19c5801325a614cc2c67fb6c280b8fb6aa18ed51c82ce85ccc0805",
    "grid075/f32q/bf16p/norm":
        "8f788016f9de74ff0c0e902bd6512faa2efb06309767c6b4e531059144a2b818",
    "grid076/f32q/f32p/norm":
        "8b3be923dc9bc569c7dc0c32c44fe3e384cbfe09ece1d51c4dd954bccb44522f",
    "grid077/f32q/f32p/norm":
        "1abb510593fb7118b914a7623e0ecd92e805c0eecad81dbea599d028686ded46",
    "grid078/bf16q/int8p/stats":
        "e39a999f5cfc1726c2828cfab46a4d2b44cef952aac263df1d1d60530d8a227d",
    "grid079/bf16q/f32p/stats":
        "d6c3f73feb15530e9676aad2c07dd2ea87f4ec2b44c865a7a8e11ebf06d2aaac",
    "grid080/bf16q/f32p/norm":
        "c6ec2fa597d54c3a94d1857b4eb7e60aaad7b74470a75e0d4cd6bc455096ed51",
    "grid081/bf16q/f32p/norm":
        "42a38f57c77273893b5190a6777aefb977236fa8a6317d1d2a4c0f50457e522b",
    "grid082/bf16q/bf16p/norm":
        "055ebaf565e4048a4261c80da41abfa779835518a2a2476865379acfbf5370ac",
    "grid083/bf16q/int8p/stats":
        "2aa9f7dbb48ad0259b3d0524525b425736fc2972de8c1227e603a4f27fe137a5",
    "grid084/f32q/f32p/stats":
        "9d2c2ba17403347b7ad119d6662cdbb5acc70d5eb40e09a1019cef7bf0bf7674",
    "grid085/bf16q/bf16p/norm":
        "188f98b53f75452fe40138baa78168592efe5e86fbf6f57e125bdf6268c30360",
    "grid086/f32q/int8p/stats":
        "4fdfbb8d8dd87c880c6bed97a2ec8d5d1604967382cc7bc3a7f3afde11e373ff",
    "grid087/bf16q/int8p/norm":
        "a580811231be014bdccd2f50dd058c7e251caba84b95be0468690c6f4d640784",
    "grid088/bf16q/f32p/norm":
        "c76b4f7ae11b811b7f54cb491d1e7149e2d7478f709362456275525201e01c8c",
    "grid089/f32q/int8p/norm":
        "ef4d71995c3f62d6a751853b158f365e5102ec0578ccf9f301b2e4b7b1454fed",
    "grid090/bf16q/int8p/stats":
        "c58770afff5244038533514fa28beb193a66ed0b841ac0d775c762f2ef87071b",
    "grid091/bf16q/int8p/norm":
        "98a814b3aa471f1445f2a7f39c1d57c0b3ade26a502512faf8f3660b2ebaffa8",
    "grid092/bf16q/f32p/stats":
        "365bf3a195585a3386f832b3165d57d62bde43d6d94d4e0bad3ea7d378b6ee61",
    "grid093/f32q/bf16p/norm":
        "ba26071fd24025489f49368f7baa2d77f41685bcbabfdd8ff4d87d4a64c6cabc",
    "grid094/bf16q/bf16p/stats":
        "61deab89762dfc8b99626cde16de3cb9b314be3076f401415d201ac599963e63",
    "grid095/f32q/f32p/norm":
        "1006a690449a1506e651430f9f17a0aff3bfcf905c6ba7803ea1e55c379bdd23",
    "grid096/bf16q/int8p/norm":
        "b6648b539ee57a5938c8d3b753df350b909b079984abe4864d3b79dbf5178198",
    "grid097/bf16q/bf16p/stats":
        "3e37b9f7432f9bdb9cf741d2a6c75f049eee16df6280dfb87def70a4c853c77f",
    "grid098/f32q/int8p/norm":
        "997121a7b46cbfaa0ca6810410819f0ae2015ec1a8c280dd02c95fe0ba881600",
    "grid099/f32q/f32p/norm":
        "94fb8ee5c2a09441fb8d147b6e789731cd9543444888eafa9f78b15ef9482421",
    "grid100/bf16q/f32p/norm":
        "96f14d47c5581bdad749502978fa6b7556b6ada962c81bc5defdbcabe7e797ae",
    "grid101/f32q/bf16p/stats":
        "97c46171defa62f250f0385d6857e55072b91b617dc51222cb0f193076c850c3",
    "grid102/f32q/bf16p/stats":
        "40af972441c618d2a7825495199e32a2e4e81be67552400164b075f6834b4874",
    "grid103/bf16q/int8p/norm":
        "1f6c738dc8f2522dcf3a15596612c3e619a27b646aef31bc701dec89d39273bc",
    "grid104/f32q/bf16p/norm":
        "8481151d4ae6ebf7d88fbc84dff718f988f3732e680200cf96214efd5bbec316",
    "grid105/bf16q/int8p/stats":
        "06b9cbaf984d67aaa6392868865d4c0afeb83c4154a930b54255991421e76bcf",
    "grid106/bf16q/int8p/stats":
        "3bdefd1dd37e6e861316f86386b4c0e3753c4df95738785140b71ba1f7554e31",
    "grid107/bf16q/f32p/stats":
        "daa884b7c9ba119a3e83b90bb3e0a302171fd0647fd445d3c8cc53937c718144",
    "grid108/bf16q/bf16p/stats":
        "946e8cf490514abf5e8f12833b94e50bea1e5d3ecabb48d6d9c16d8113b289cb",
    "grid109/bf16q/f32p/stats":
        "92719031857f1fb255a6747d84cab930fe46ea699190e0f30bc39f7546474f0a",
    "grid110/bf16q/int8p/stats":
        "b9178a22dbeb77c3840b1590aee148b40120f1f5670d8d2648b176c14bc4b997",
    "grid111/f32q/int8p/norm":
        "48617da7c110a97a342844445ef40c1b0e0c7924a8a9df02c87953cbe0a26670",
    "grid112/bf16q/bf16p/stats":
        "7f742ffd01c37089d98930b5bfd03ec74afcb68907dbbfdb80ab06f89fc8d16d",
    "grid113/bf16q/bf16p/norm":
        "d391ce9f2ff8474f97327b0fe0ad9be439261da14313d70ee35eea59122c57c8",
    "grid114/f32q/int8p/norm":
        "f66f3156b38eadbc6ebd6108ec093a7b5b1b01a1ad1fb6049743a2efbcf806e2",
    "grid115/f32q/bf16p/norm":
        "7243e0dfcb41fe1d170e91d116dcfa38fa67288890fd63ea87585b756ea36ac7",
    "grid116/bf16q/int8p/norm":
        "174b7ee4896135e50a7b133513c8960771c213c4acf1aeac4a0001905e67c538",
    "grid117/bf16q/f32p/stats":
        "6a985abcc8be8715183854b455f0b178045da789ec0a66fbf43d803110e6fa3c",
    "grid118/f32q/int8p/norm":
        "82f105c81609a4b1166b115b994e21bd43116490561d2eca6de9def172547a0e",
    "grid119/bf16q/f32p/stats":
        "b37403f75d986e52d07950dd6905185298a3c14fba8917cbed8a2cb82fbadf08",
    "grid120/f32q/int8p/norm":
        "bcc87fefc2c881cbd9f0843f2bb204760f2075640e8399a45f62eda432391003",
    "grid121/bf16q/bf16p/stats":
        "c1cd53333e9bbc24dbc07c4eb82a6e6056954ec7cdabb5b4de1dc81c3829c4c3",
    "grid122/bf16q/int8p/stats":
        "f0800e88fe28df7c8ab3daff9a1cf167c395c4b9c996cb74c34d87b21d653d6d",
    "grid123/bf16q/bf16p/stats":
        "50641ee15b84236281946ab994f03deb4e804b2e27ad93a8b9e13469e65f270c",
    "grid124/bf16q/int8p/stats":
        "c855b54e0d98d1c82801423a71f4b0226e8d9967508ee3047099884fc50ef1e0",
    "grid125/bf16q/f32p/norm":
        "23a4e198c2a4d786cad18c91b9fa63569ddbc8f440f2c0ee8689e57438f318c0",
    "grid126/bf16q/int8p/stats":
        "990b6fe552d5d0851180e61f659e075498775cd4db153b9ab8c8aa6bd9867a89",
    "grid127/bf16q/f32p/norm":
        "fd5abb861f1e4d47d98ffe9a61eba2a80ae89c2cde40ab91b6a1e4829c5173e0",
    "grid128/f32q/bf16p/norm":
        "e67c15f59d10196e855a6f195bba7dac81b0ce326d68abf06f3edcafd1c4dd6d",
    "grid129/f32q/f32p/stats":
        "f263cdd88d94e26254aad8bba5bdff03fd37f047e4609e9c089b078a62ffbb98",
    "grid130/f32q/int8p/stats":
        "08e809f692b28d9b6cf7956f94b1720413219cc7c52e9935516969a331be24f7",
    "grid131/f32q/int8p/norm":
        "928415fa8f21a952ffb1ea1aea12ea104093ae5c6d233ac4d94eee83f04ff49a",
    "grid132/f32q/f32p/stats":
        "f0dcd542689917885ed842cf78d8aa3bbf3959854d838a36a7c723d758c4fff2",
    "grid133/bf16q/f32p/norm":
        "5e57ae731ed8d2d74808be15fc897cfa8dc041552639b69e4ddabd7653cde6b5",
    "grid134/f32q/int8p/stats":
        "86e3a7b4002d98d833027cf4ec910e9a74578cc30bb8b1493036fbfd933d16c6",
    "grid135/bf16q/int8p/stats":
        "d6424c1c4fc94241acb8437bdcdc81a58a47851ce7129241511fddd4779b41bc",
    "grid136/f32q/bf16p/stats":
        "f7685346cd93051f01291b6a86105389df1335f82bf7616174acb787c27a7384",
    "grid137/f32q/bf16p/norm":
        "605bc461d26fa137432592bb310ebf974e04d93f83001486927c8f6c8ec51cb6",
    "grid138/f32q/int8p/stats":
        "dd5e18d34f21ed07648b6c03be0a4e4fdffb9ab074f99e80cf81b2ee04f24639",
    "grid139/bf16q/f32p/stats":
        "ff6b21dd1bdf2b9ce5f0f0ba43f1767126d167a7414a3e7f18bb8284ebc23cc9",
    "grid140/bf16q/bf16p/norm":
        "e872542aa9739c63b6f2bbeedc68b35ffa67928be834b3f9ba28101657cb1992",
    "grid141/bf16q/int8p/norm":
        "e2d35134572ce74300696fa8125b1781b82cd226ab6ad92c4d298a5a191438a3",
    "grid142/f32q/bf16p/norm":
        "ecf8d708a00752e6d83114a9c3f72f75c8b9801243bbcf027d07642c3bd4af18",
    "grid143/bf16q/bf16p/stats":
        "b91b5da990368d3e548fbbe2df6146971271a94d57b5f89fc4188cd9db3db440",
    "grid144/f32q/f32p/stats":
        "86d351985a9cb8d645fcef125bb4faa1af9718462a70584af6bbb09aa57baa0c",
    "grid145/bf16q/bf16p/stats":
        "4014e9616bdad1512ba70243ab670853571642e0b02a7c919bce1c4797051a3e",
    "grid146/bf16q/bf16p/norm":
        "e6f0879b5282b9c0f1b7490784e2e80569e2d1723de145b8969975124d7d50b1",
    "grid147/f32q/f32p/norm":
        "1aa51a565637ba0d2cc8c1649fd760b9be1a8b427e4b4996a7ada24503f672f9",
    "grid148/f32q/int8p/stats":
        "8fbfe0c6088a29b91f07aee78f032a7792de80408b48f070062abd28d1f7c6eb",
    "grid149/bf16q/bf16p/stats":
        "20889762a4081c3718b70c7a1fd54c3b2ff0b0708e1a244de4926daaae5ebb5a",
    "grid150/bf16q/int8p/stats":
        "a0f0f7967f5ae934170f9abc50945ca76e493aad7f19415c485072ce8e1a20e7",
    "grid151/bf16q/f32p/norm":
        "903952ee58d8e6d3e43a932c19a731aee7002ee3166646421f5d0d61de16310f",
    "grid152/bf16q/bf16p/norm":
        "e6a7de194932d7e426c08bc247abf7f11523e0df33d013d3871698e17b3c24bd",
    "grid153/bf16q/bf16p/norm":
        "8f59537d2db3a40566d10235612b22fa56849d0a69d1fef170c144e94aed6125",
    "grid154/f32q/f32p/stats":
        "fb56d76a70560472a01156b1ef06b20ef88614c36241f4ef8e76725f8a73edad",
    "grid155/f32q/f32p/norm":
        "7768b1ac626e5019488c6faf9bada5a9a1132d88b6eee5edd3c0030a2920942e",
    "grid156/bf16q/f32p/norm":
        "65a90f9cce6e2ea6b68523d4d866194d429c08d8f358e66dd5a80a644ff5003e",
    "grid157/f32q/int8p/norm":
        "d558a4c0fa0ae2bf8918467f3739674e69e2e8df5ae9b531f9ac51620215643b",
    "grid158/f32q/bf16p/norm":
        "614c5799d3b13c6dec206816f590a4183e8d5d055bd7de2667472322d7d533df",
    "grid159/f32q/f32p/stats":
        "c307f89355eea320dec7eef04b53eb2cd97096e14e6e76f9ce9dc4ac109712a2",
    "grid160/f32q/f32p/stats":
        "89922395ece98b9f653a2ae6c398362b1c17a7753c25515659602cd787b374aa",
    "grid161/bf16q/int8p/stats":
        "f9634985660a63d0791d28ae9840c7d6062531edf0067220ac5c4f2429cfacf7",
    "grid162/f32q/int8p/stats":
        "b20ae08bbc3d41728073d7e5cc42dadd695d29c95c44c206d28f245b63c512ba",
    "grid163/f32q/bf16p/norm":
        "9ff7b5fae8dd9d2e40a45d240b965fec3ca7fedc187604f449ff3291db1e391b",
    "grid164/f32q/bf16p/norm":
        "ba4e01d079038c63e8e2b1356802da34666caf74d9235c10e1143c51f743c22b",
    "grid165/f32q/f32p/norm":
        "93ecb3accf57b98409260a038ed78903995be410cc7e519fffa2faf10beda3e9",
    "grid166/f32q/f32p/stats":
        "236fb883657679cb041f1973e8767dc5c9da640e965e31fd41af9012f4e473dc",
    "grid167/bf16q/bf16p/norm":
        "80a07d5cafb404634141412f92f98e175f89d91f4cb22fad121ffcfd41932c46",
    "grid168/bf16q/int8p/norm":
        "2514dc92cf676470423d8fc3e1a1609eb97007bb54d0abdab940add2f3f29da5",
    "grid169/bf16q/f32p/norm":
        "f8a8b052e9ae00053c0deae6990c439f808089745bc166c8e4e484abdfdf5769",
    "grid170/f32q/int8p/stats":
        "5ee7e1a73b7184323163deb095e4eac4dbfab436992fe608619fabbfd916f8cd",
    "grid171/f32q/int8p/norm":
        "ff635220cd4f9056fe6dc91d7b51664a5f502d69f185fa4492652db1ca18fd74",
    "grid172/f32q/int8p/norm":
        "ac33ae579b4f2befc788d9d81229e0720a2992a3a92118a304bba485bb912eec",
    "grid173/bf16q/bf16p/stats":
        "121ffa6516d704f1b9f24dd8f9679d540a90add8e194e51f145146b51abd67b4",
    "grid174/bf16q/int8p/norm":
        "3ae001abea3cb274b32e53b0a6d7e5597c0ec9cdc3666388df1dac71ba3b39f1",
    "grid175/bf16q/f32p/stats":
        "d5a77937c695c7ea5405ec6804b338a06c06038e08b611b8bcd4e8867875abc5",
    "grid176/bf16q/f32p/norm":
        "6821c95800d11f9ad1491f7e443d11b45ec698a3b19f9475adaa526caa1fb9ef",
    "grid177/f32q/bf16p/norm":
        "64ff002d4869baf55365fda578cc72626ba6e0a76b8bd1cbee76860f87d18ff1",
    "grid178/bf16q/int8p/stats":
        "a7e04cb9c387762e659ef206b2f35f01ad4d13d59d3a3a2583a3c5eac6960185",
    "grid179/bf16q/f32p/stats":
        "3bf65e0aa9fe892b2d64a512aa0349c163909642dbb0f1c61e74e59ae0a6d1b9",
    "grid180/bf16q/bf16p/stats":
        "2f424433af272621de43ff074af0bb8c0ddb6bb6f6112e45eb74bf5a83336b98",
    "grid181/bf16q/f32p/stats":
        "9fde35d96633e34b375f31890e0c1a3cdcdcc3075f825ef1c9c0a3780ba160d4",
    "grid182/f32q/int8p/stats":
        "733b2c8dc49347183cab9c3b5654b49ee3d8d8077676e81c5ce37b01b3fc4aaf",
    "grid183/bf16q/f32p/stats":
        "217da903107d2d0f17ea9124f3dbd054f499c9d356cea3f03c15ab5efe539f0f",
    "grid184/bf16q/bf16p/norm":
        "6edfda5fdad5b4cda8acf74519696e5543cb00ae2846a3f50b2134da6a324655",
    "grid185/bf16q/int8p/stats":
        "6f5a07103eeba7c31445486ac8e8a3f3a5b189cd35290facde7325f0a6d7fdae",
    "grid186/bf16q/f32p/norm":
        "3923e545a7c290d366aecb561aa703090391877dcb87131e52446e01f7dbcd4f",
    "grid187/bf16q/int8p/stats":
        "f2b962a3b0b54db4fe3436178548259106aa1f06e1986d2d3de036d6f5ac04d2",
    "grid188/f32q/f32p/norm":
        "93b2dc9c81444c28156ad764c7480d18590dba3c5ee11953a18327bdee967c51",
    "grid189/bf16q/f32p/norm":
        "7f9d38231a7d4fa1dfb842af5950c9dbac5a53dc757704ecda9e9879e57a7db7",
    "grid190/f32q/int8p/norm":
        "06cc5d691095b22a3961b903852655e8ef5fbffedfa93fb0445c6cebaae200a6",
    "grid191/f32q/f32p/norm":
        "377d7f9317b0ed093669188318e1d51f6f1aff7bd3d48317f186db27b7974ae1",
    "grid192/bf16q/bf16p/stats":
        "863efa7a695c65709ec15f4ee9bb0e56c33e802e0bec86c33eb90773defaab44",
    "grid193/bf16q/f32p/norm":
        "1c4e57f5599335672f4f095615250ff2e9901bee4d359a9367ca23b352fb0974",
    "grid194/bf16q/int8p/norm":
        "34b2c3fcdd6122d0aa5f0bc46147b498511ee4887a7e2dc470443d96d971404f",
    "grid195/bf16q/bf16p/norm":
        "342941ce4adadd4800c4178a0be37c7b6f90ffef5634c9c68f1b3d0f8aadcef3",
    "grid196/f32q/int8p/stats":
        "d537a7779e5115c730cde8c5b07eab51a5c60890171965b8be5c6d1070036b15",
    "grid197/f32q/bf16p/stats":
        "50cb066f765b53264759d2073ec3da5f9cb4e842852ed695a7d471b99f7c709f",
    "grid198/f32q/bf16p/stats":
        "e4195a4b2624f3829bcd61390b86f28a9391d6d411322aa1fdab10b6abdc1ee3",
    "grid199/bf16q/int8p/norm":
        "aea11d86a4100bcf078c8b611516935a739c185a1c20a72ac3e11932dbeb1c5e",
    "grid200/f32q/int8p/norm":
        "901df638258aaf54e0a4572609c087e3bb3f58b23e82d6563f3dd9a9a5a42f49",
    "grid201/bf16q/int8p/stats":
        "be38d9257b681054ed323a826cd6c352bb67bee8f17063c4b75633db4a10e829",
    "grid202/f32q/f32p/stats":
        "e0809b7fedf8c5b63634b9d0878829444aad507ba2ac52e79b5a1c06b68b8223",
    "grid203/f32q/bf16p/norm":
        "a5228198053420485e354f467334a22e077a0b269441cada5683446df0ae1033",
    "grid204/f32q/f32p/norm":
        "585347ce817dbed9d78327559b50aea2d5fa9018ffb5cf304c4c39775b103b3b",
    "grid205/bf16q/int8p/stats":
        "62e64337f1873164a827e73b1fdaf84a1b1b22559e2ce619949bf4c317dc14f4",
    "grid206/f32q/f32p/stats":
        "d53d2234b40da0c2bb7a1e31b979f6cf89638c31662d75b40a669e066b259747",
    "grid207/f32q/bf16p/stats":
        "fd7854249e9dfca0e0b2661a7f6c073355d70d752bb815353a77c0d4df10494e",
    "grid208/f32q/bf16p/stats":
        "76ba517e75c2962dbd076d50e9dd27d7c5a9771498bde3dae3b09958306bda6f",
    "grid209/bf16q/int8p/stats":
        "019c4aafe229fd298c8c34129ff319f1b9703586d893d14dda41676e181f4e66",
    "grid210/bf16q/int8p/norm":
        "f81316240404370e2b1bb7ea64ae2103c02ed98944389cd8f0865fb441acc913",
    "grid211/f32q/int8p/norm":
        "0fcf405349951dd337e91ac75c0b82c082612b2265c76e5cbc339a5031ae7916",
    "grid212/bf16q/bf16p/norm":
        "60c8c81ded1e8ba70e4769ec6116f9ecf03ade806f2117106bee49ca844cd11e",
    "grid213/f32q/int8p/stats":
        "97d3c8dd3f670f771d3c7757757a4f39384cadc01439853168adb86d27c5efe1",
    "grid214/f32q/bf16p/stats":
        "92367a801e6c56911ae663a821ee6832fe1cef0bbf7046e09da7fc50f23064bf",
    "grid215/bf16q/int8p/stats":
        "0dea20d77b9f9df262f651a14bb98a1c2e61af0b20380a210e5a57f0003517b3",
    "grid216/f32q/f32p/stats":
        "3767c27e420550cf65a0256823cf8a475c9c2271a7a6e5c0485b953cdc9558ec",
    "grid217/bf16q/bf16p/stats":
        "87991b0dae2939d513792d7ceca8aaee28eccf96e47c0c99c0361239b47ab44a",
    "grid218/f32q/f32p/norm":
        "e554a9e7f3bc6a510b70e4f7bcfc2b1e8f2f8927b46d559d8eda72162612ff0d",
    "grid219/bf16q/f32p/norm":
        "1a89e45848fcef51144afc9f5abfd6873e43471cb6f4849d079a7afaf0420fe4",
    "grid220/f32q/int8p/stats":
        "5d4c9fa6983d4c9f6090a8f51fcbf790b266c07614f0f9d15acab5f956f9e308",
    "grid221/f32q/int8p/norm":
        "3a893b2f2b4e215c14e3c3093aec32eafcebb816d266b9aa47d27edb1ab57812",
    "grid222/bf16q/bf16p/norm":
        "ceebe2b4ebc9bab0998ad5de3eaf97ac90fc196b3d59a075525b3b3448ca34cc",
    "grid223/bf16q/f32p/stats":
        "73a2da29b9121da6fa8ba6b6c2fad8ccea9571b43140d7c59e11642e09c2d87f",
    "grid224/bf16q/int8p/stats":
        "04aecc21025889a4dbb293e39518c9a93828ea9eed47baa08b48560372a4fa7b",
    "grid225/f32q/f32p/stats":
        "2505388e8f7fb5de34c13204c41d00d7b6539a6ef8319c5937cff754a1dbc0bd",
    "grid226/bf16q/int8p/stats":
        "25c009877459e7bd333c1b8fe7c331a2df0705fa6e9ca960b9d208ce4f25d59a",
    "grid227/bf16q/f32p/norm":
        "c05165f5bf666b6f29e62111e1ef0bb6cb29abc911fe07839371cb157726fccb",
    "grid228/f32q/int8p/norm":
        "9dedaf0da055ebcad76a4ec6230db7a20361746c9b0be5506dca19566058bda9",
    "grid229/bf16q/f32p/stats":
        "b93dd893e99db6419550846fcfa088e2dad2b0ef56b79e83a8aa000f6bcb62f5",
    "grid230/bf16q/bf16p/norm":
        "5baa8a676c39ed5a12a0f18c2a1ea54165c3b399d8e548f406053d8861fa38ab",
    "grid231/bf16q/f32p/norm":
        "32dff6e022bf22e7b6f172fc61437f7bec987faf8b732b65c67f1221b8e4d51f",
    "grid232/bf16q/int8p/stats":
        "73c3771ce2d1c543dd27fab6368c0765bddeaf967349fb31ab9e2e17ec0aa4aa",
    "grid233/f32q/f32p/norm":
        "4414b9c5593d8d5dd62cf0c7c2bee712579fd278cb7fe911c1af0665e0497734",
    "grid234/bf16q/f32p/stats":
        "b2bdbe46e233c5e3344d4af8f646d28da6fd0adfcfccacfc0aea3384596f6889",
    "grid235/bf16q/int8p/stats":
        "efcae765e423cb631192bca8c434f6c22d82dcd81a0b6610724e136a5fa1e958",
    "grid236/f32q/f32p/stats":
        "4f2a47b1eef0bdf9eace6a52ba8d55b54b87f0a5e658f1e2d21750f0e2a04bd9",
    "grid237/bf16q/int8p/norm":
        "e3aa1bcb803adb2e81a3616907c79ff2869ce6ad78f8f549f103b083601473c3",
    "grid238/bf16q/int8p/stats":
        "2ddc2325acf77df81e7e7adfd5abe1a21cc8eb501d2c7490725683f419bfd0ea",
    "grid239/f32q/int8p/norm":
        "23efe0d0faea37352bd9cf190b74bfc5ff236cc73edd8a5a376bcf680548a420",
    "grid240/bf16q/f32p/norm":
        "6c998d6e1357a2608668e0ab6f9b168e95e97ab22c851408f3f8185f966b1934",
    "grid241/bf16q/int8p/stats":
        "ef290939ade41fafd5748a2525a9e99e09b2bdc67e9685424af587347f59d721",
    "grid242/bf16q/f32p/norm":
        "d51c0beb908742a70cd2a2216a8c7a4f99130b9bfc5c5e6446e2e43416057c00",
    "grid243/bf16q/f32p/norm":
        "5e31f1b1df90fe08d21f63a52d371158f5a87c562011c758fb5537ce42dd0cbb",
    "grid244/f32q/f32p/norm":
        "f63f421cca253ea207b0888502a14912f9becdbab6d1c2832053e5118dac3f49",
    "grid245/bf16q/int8p/stats":
        "b78291a14e6315baa3534f5bc8c5e37cd181b98331875542cafb9521804d236c",
    "grid246/bf16q/int8p/stats":
        "b9f4ddf8ca098b8948462e05bb870b27f8fda267d4968b18d1d24e9786e998ea",
    "grid247/bf16q/bf16p/stats":
        "dab5d6ea2ee1defc31a26298e11366298bb7185fc96144a78a896938dc2276a2",
    "grid248/bf16q/int8p/norm":
        "d61e32f73ce8c52c573d4290cef1330c01b98059db8cbe47ce4c7c9e119109b4",
    "grid249/f32q/int8p/stats":
        "375528cfeeca0b5d983973449201aaab7ad34a90d7994e56df7176fffcc47c0b",
    "grid250/f32q/f32p/norm":
        "9c7d2a6c9e3d1c571b5f6948583cea590e2a1d737f472e9314e5b6725432f1aa",
    "grid251/bf16q/bf16p/stats":
        "f41a8a836bfdc1d97bcae064892b55ce819ecd159292e2175d42b0157dd637e3",
    "grid252/bf16q/f32p/norm":
        "572837438b495291214b86a7a4b74785043f54570e63ce4b30d9fac31f651885",
    "grid253/f32q/int8p/norm":
        "e18b60a677d0aeae1df3316925db416f71e9b8939ecb53553d92ddb1868a2a9e",
    "grid254/bf16q/f32p/norm":
        "adaa1d3b4084f5918785001d396dd609168f75d741b73d63681217ccbaa14964",
    "grid255/bf16q/f32p/stats":
        "6f8fa20135a73904e68a7945c5a91961aba3a050f4178ecb22848378ad6551f8",
}
