"""Kernel routing, launch counts and the CUDA build.

The route is decided by where the operands lie: tensors on the card go to
the hand-written CUDA kernel, tensors on the CPU to the kernel's plain
PyTorch version.  There is no mode switch: a CUDA tensor always launches
the kernel, and a failed build, load or launch raises.

Each kernel source in ``csrc/`` is compiled by its own ``nvcc`` process,
or by one a part where ``PARTS`` splits it (all started together), into a
shared library with a plain C interface, loaded with ``ctypes``.  The build lives in ``build/repro_torch/<hash>/`` at
the checkout's root, keyed by a hash of the sources and flags, so a stale
library is never loaded; it happens once per checkout, at first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("nm_spmm", "paged_attn", "nm_mask")  # csrc/<name>.cu, one library each
# the kernels' entry points, each with its own launch count: the batched K1
# lives in nm_spmm.cu; K2's GQA, MLA and window forms, their stats flush
# (K3) and the int8 option (K2q) of each in paged_attn.cu
PAGED_ATTN = tuple(f"paged_attn{form}{flush}{quant}" for form in ("", "_mla", "_win")
                   for flush in ("", "_stats") for quant in ("", "_q"))
KERNELS = ("nm_spmm", "nm_spmm_batched", *PAGED_ATTN, "nm_mask")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# sources compiled in parts, each part (``-DKERNEL_PART=i``) by its own
# nvcc, the objects linked into the one library: paged_attn.cu's 112
# kernel instances took over three minutes in one compile
PARTS = {"paged_attn": 9}

# a block's shared memory on the H100 (the kernels' launches refuse more)
SMEM_MAX = 232448
# launches of each kernel since the last reset_launches(); the plain
# versions never count
launches = {name: 0 for name in KERNELS}
# K1's and K1b's launches by the body they ran (``nm_spmm.launch_plan``):
# "decode" (B <= 8 rows), "tc" (the tensor-core prefill body) or "body"
# (the first version's: f32, or a decode x past its staging budget)
routes = {f"{name}/{route}": 0 for name in ("nm_spmm", "nm_spmm_batched")
          for route in ("decode", "tc", "body")}
# the blocks a lane (S) of each window entry's last launch (its split walk)
last_splits: dict[str, int] = {}
# the seconds of each compile of the last build(), by source (and part)
build_seconds: dict[str, float] = {}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for counts in (launches, routes):
        for name in counts:
            counts[name] = 0


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every operand lies on the card, False when all lie on the
    CPU; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("operands lie on different cards")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands on mixed or unsupported devices: {kinds}")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_dir() -> Path:
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(sorted(PARTS.items()))).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile every kernel not yet built for these sources, one ``nvcc``
    per source or part, all in parallel; each compiler's output goes to
    ``<name>.log`` beside its library.  Raises if any build fails."""
    out = build_dir()
    todo = [name for name in SOURCES if not (out / f"lib{name}.so").exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    build_seconds.clear()
    tag = os.getpid()
    jobs = []  # (source, label, log path, process, start)
    for name in todo:
        src = str(CSRC / f"{name}.cu")
        if name in PARTS:
            cmds = {f"{name}.{i}": [nvcc, *NVCC_FLAGS, "-c", f"-DKERNEL_PART={i}", "-o",
                                    str(out / f"{name}.{i}.{tag}.o"), src]
                    for i in range(PARTS[name])}
        else:
            cmds = {name: [nvcc, *NVCC_FLAGS, "-shared", "-o",
                           str(out / f"lib{name}.{tag}.tmp"), src]}
        for label, cmd in cmds.items():
            log = out / f"{label}.log"
            with open(log, "w") as f:
                jobs.append((name, label, log, subprocess.Popen(
                    cmd, stdout=f, stderr=subprocess.STDOUT), time.perf_counter()))
    failed = []
    while jobs:
        for job in [j for j in jobs if j[3].poll() is not None]:
            _, label, log, proc, t0 = job
            build_seconds[label] = round(time.perf_counter() - t0, 1)
            if proc.returncode != 0:
                failed.append(f"{label} (nvcc exit {proc.returncode}):\n{log.read_text()}")
            jobs.remove(job)
        time.sleep(0.1)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    for name in todo:
        tmp = out / f"lib{name}.{tag}.tmp"
        if name in PARTS:  # the parts' logs in order, then the link
            labels = [f"{name}.{i}" for i in range(PARTS[name])]
            objs = [str(out / f"{label}.{tag}.o") for label in labels]
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                                  capture_output=True, text=True)
            (out / f"{name}.log").write_text(
                "".join((out / f"{label}.log").read_text() for label in labels)
                + link.stdout + link.stderr)
            for obj in objs:
                os.remove(obj)
            if link.returncode != 0:
                raise RuntimeError(f"kernel link failed: {name}:\n{link.stdout}{link.stderr}")
        os.replace(tmp, out / f"lib{name}.so")  # atomic: a concurrent build never sees half
    return out


def load_kernels() -> None:
    """Build (if needed) and load every kernel library once."""
    if len(_libs) == len(SOURCES):
        return
    out = build()
    for name in SOURCES:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))


def kernel_fn(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of the library built from
    ``csrc/<name>.cu``, typed (cached)."""
    if symbol not in _fns:
        load_kernels()
        fn = getattr(_libs[name], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return _fns[symbol]


def check_launch(name: str, rc: int) -> None:
    """Raise on a failed launch; count a good one under entry ``name``."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {rc}")
    launches[name] += 1


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
