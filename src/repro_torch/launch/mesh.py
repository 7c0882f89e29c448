"""Local ``(data, model)`` meshes of ``torch.distributed`` ranks (counterpart
of ``repro/launch/mesh.py``).

A mesh is one process per device slot.  :func:`run_ranks` starts the
``data × model`` ranks on this host with the ``spawn`` start method (CUDA
cannot fork), joined by a ``FileStore`` in a temporary directory (no TCP
port, so parallel runs never collide), and runs one function on each,
inside the package so that a child imports only ``torch``.  Rank ``r``
works on ``cuda:(r % device_count)`` (or the CPU).  The process-group
backend is decided before any rank starts, and printed: ``nccl`` when
every rank has a card of its own, ``gloo`` when ranks share a card or run
on the CPU (NCCL refuses two ranks on one device).  A failed start raises;
nothing falls back to another backend.  Inside each rank
:func:`make_local_mesh` describes the mesh.

The TPU roofline constants of the reference module are not ported.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import traceback
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.sparse_infer.compress import CompressedTensor
from repro_torch.utils.device import resolve_device

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a ``(data, model)`` mesh.  ``axis_names`` and
    ``devices`` (an array of the mesh's shape) match the reference mesh's
    attributes that the placement rules read."""

    shape: tuple  # (data, model)
    rank: int
    device: torch.device
    backend: str  # "nccl" | "gloo" | "none" (one rank, no process group)
    group: Any = None  # the process group of this rank's model axis (None: one rank)
    device_names: tuple = ()  # every rank's device, in rank order
    axis_names = AXES

    @property
    def devices(self) -> np.ndarray:
        return np.array(self.device_names, dtype=object).reshape(self.shape)

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def model(self) -> int:
        return self.shape[1]

    @property
    def model_index(self) -> int:
        """This rank's coordinate on the model axis."""
        return self.rank % self.model

    def describe(self) -> dict:
        return {"shape": list(self.shape), "axes": list(AXES), "backend": self.backend,
                "devices": list(self.device_names)}


def rank_device(rank: int, device="cuda") -> torch.device:
    """Rank ``r``'s device: ``cuda:(r % device_count)``, or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def pick_backend(world: int, device="cuda") -> tuple[str, str]:
    """``(backend, why)`` for ``world`` ranks on ``device``'s kind."""
    if resolve_device(device).type == "cpu":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if world <= cards:
        return "nccl", f"{world} rank(s) on {cards} card(s), one card each"
    return "gloo", f"{world} ranks share {cards} card(s); NCCL takes one rank per card"


def make_local_mesh(model: int = 1, data: Optional[int] = None, *, device="cuda") -> Mesh:
    """The ``(data, model)`` mesh over this host's ranks, as seen from this
    rank.  With only ``model`` given, ``data`` is ``ranks // model``.  The
    reference's checks: axes of at least 1, ``model`` no more than the
    ranks, and a shape needing more ranks than exist raises; where the
    reference warns and leaves devices out, a process group cannot leave a
    rank out, so a shape that does not cover every rank raises too.
    Without an initialized process group there is one rank, and only a
    1×1 mesh."""
    if model < 1 or (data is not None and data < 1):
        raise ValueError(f"mesh axes must be >= 1, got data={data} model={model}")
    ready = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if ready else 1
    if data is None:
        if model > n:
            raise ValueError(f"model={model} exceeds the {n} local rank(s)")
        data = n // model
    need = data * model
    if need > n:
        raise ValueError(f"mesh ({data}, {model}) needs {need} ranks but only {n} exist")
    if need != n:
        raise ValueError(f"mesh ({data}, {model}) covers {need} of the {n} ranks; every "
                         "rank of the process group must be in the mesh")
    rank = dist.get_rank() if ready else 0
    group = None
    if model > 1:
        rows = [list(range(d * model, (d + 1) * model)) for d in range(data)]
        # every rank creates every group, in the same order
        groups = [dist.new_group(r) for r in rows] if data > 1 else [dist.group.WORLD]
        group = groups[rank // model]
    return Mesh(shape=(data, model), rank=rank, device=rank_device(rank, device),
                backend=dist.get_backend() if ready else "none", group=group,
                device_names=tuple(str(rank_device(r, device)) for r in range(need)))


# -- launching ---------------------------------------------------------------


def _save_tree(tree: dict, path: str) -> None:
    """A parameter tree as nested dicts of CPU tensors and plain values, one
    file, so every rank can map it and take its own slices."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, CompressedTensor):
            d = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
            d.update(values=x.values.cpu(), indices=x.indices.cpu(), shape=tuple(x.shape))
            return {"__compressed__": d}
        return x.cpu()

    torch.save(conv(tree), path)


def _load_tree(path: str) -> dict:
    """The tree :func:`_save_tree` wrote, memory-mapped on the CPU."""

    def conv(x):
        if isinstance(x, dict):
            if "__compressed__" in x:
                return CompressedTensor(**x["__compressed__"])
            return {k: conv(v) for k, v in x.items()}
        return x

    return conv(torch.load(path, map_location="cpu", mmap=True, weights_only=True))


def _rank_main(rank: int, world: int, shape: tuple, backend: str, tmp: str, device: str,
               timeout_s: float, fn: Callable, args: tuple) -> None:
    """One rank: join the group, build the mesh, run ``fn(mesh, tree,
    *args)`` and leave its result (or its traceback) in ``tmp``."""
    out = os.path.join(tmp, f"rank{rank}.pkl")
    try:
        dev = rank_device(rank, device)
        # the ranks share the host's cores: intra-op pools spinning on every
        # core starve the collectives' transport threads (CPU ranks with a
        # share of 4 threads each: 2.6 ms a gloo all-reduce against 0.25 ms,
        # eight cores, two ranks); a card's rank takes half a share, a CPU
        # rank one thread
        share = (os.cpu_count() or 1) // (2 * world)
        torch.set_num_threads(max(1, share) if dev.type == "cuda" else 1)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{tmp}/store", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = make_local_mesh(shape[1], shape[0], device=device)
            tree_path = os.path.join(tmp, "tree.pt")
            tree = _load_tree(tree_path) if os.path.exists(tree_path) else None
            result = ("ok", fn(mesh, tree, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if result[0] == "error":
        raise SystemExit(1)


def run_ranks(fn: Callable, args: tuple = (), *, model: int, data: int = 1,
              device="cuda", tree: Optional[dict] = None, timeout_s: float = 300.0,
              log: Callable = print) -> list:
    """Run ``fn(mesh, tree, *args)`` on each of ``data × model`` spawned
    ranks and return their results in rank order.  ``fn`` must be a
    module-level function of the package; ``tree`` (a parameter tree, e.g.
    the exported artifact) is written once and every rank maps it and takes
    its own slices; ``args`` are pickled to every rank.  Raises with the
    first failed rank's traceback; a collective that waits longer than
    ``timeout_s`` fails its rank."""
    world = data * model
    backend, why = pick_backend(world, device)
    log(f"# mesh ({data}, {model}): {world} rank(s) on {resolve_device(device).type}, "
        f"backend {backend} ({why})")
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        if tree is not None:
            _save_tree(tree, os.path.join(tmp, "tree.pt"))
        try:
            mp.spawn(_rank_main, args=(world, (data, model), backend, tmp, str(device),
                                       timeout_s, fn, args), nprocs=world, start_method="spawn")
        except Exception as exc:
            raise RuntimeError("a mesh rank failed:\n" + _first_error(tmp, world)) from exc
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"mesh rank {r} failed:\n{value}")
            results.append(value)
    return results


def _first_error(tmp: str, world: int) -> str:
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "error":
                return f"rank {r}:\n{value}"
    return "(no rank left a traceback)"
