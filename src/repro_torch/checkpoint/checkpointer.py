"""Checkpoints, and the JAX weight carry-over.

Counterpart of ``repro/checkpoint/checkpointer.py``.  A checkpoint
directory holds ``arrays.npz`` (one array per leaf, keyed by its '/'-joined
tree path; bf16 leaves stored as uint16 views under a ``::bf16`` suffix)
and ``manifest.json`` (sorted keys plus an md5 per array).  Both packages
write and read the same format: a training checkpoint of the port names its
leaves as the reference's ``TrainState`` does (``params/…``,
``opt/m/…``, ``opt/autoswitch/window``, ``recipe/step``, ``data_state``), so
the reference's ``load_pytree(path, {"params": …})`` reads its parameters.
The port's train state has no PRNG key, so it writes no ``rng`` leaf.

``save_pytree`` publishes a checkpoint atomically (written to a temporary
directory, then renamed); ``load_pytree`` and ``load_into`` verify every
checksum and rebuild bf16 leaves bit-exact; :class:`Checkpointer` keeps a
directory of ``step_<N>/`` checkpoints with keep-last/keep-every retention.

``carry_over`` feeds a JAX parameter tree, as numpy, to the port: the tests
use it to hand both packages the same weights.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.sparse_infer.compress import CompressedTensor
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_flatten_named, tree_unflatten_like, unflatten

_BF16 = "::bf16"


def _bf16(bits: np.ndarray) -> torch.Tensor:
    """bf16 tensor from its uint16 bit patterns, bit-exact."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def numpy_to_torch(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A numpy array (bf16 as ml_dtypes bfloat16) as a tensor on ``device``."""
    a = np.array(a)  # a writable copy: JAX hands out read-only arrays
    t = _bf16(a.view(np.uint16)) if a.dtype.name == "bfloat16" else torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _read(path: str) -> tuple[dict, dict[str, np.ndarray]]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return manifest, arrays


def _to_numpy(x: Any) -> np.ndarray:
    """A leaf as the array the reference stores: tensors as they are (bf16
    as its uint16 view), ints as int32, bools as bool, floats as f32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    if isinstance(x, (bool, np.bool_)):
        return np.asarray(x, np.bool_)
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    if isinstance(x, float):
        return np.asarray(x, np.float32)
    return np.asarray(x)


def save_pytree(path: str, tree: Any, extra_meta: Optional[dict] = None) -> None:
    """Atomic save of a tree of tensors and scalars to ``path``/."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    flat = {}
    for name, leaf in tree_flatten_named(tree):
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        flat[name + _BF16 if bf16 else name] = _to_numpy(leaf)
    tmpdir = tempfile.mkdtemp(dir=parent)
    try:
        np.savez(os.path.join(tmpdir, "arrays.npz"), **flat)
        manifest = {
            "treedef": "repro_torch",
            "keys": sorted(flat),
            "checksums": {k: hashlib.md5(np.ascontiguousarray(v).tobytes()).hexdigest()
                          for k, v in flat.items()},
            "meta": extra_meta or {},
        }
        with open(os.path.join(tmpdir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmpdir, path)  # atomic publish
    except BaseException:
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise


def verify(path: str) -> bool:
    """Checksum-verify a checkpoint directory."""
    try:
        return _verified(*_read(path))
    except (OSError, ValueError, KeyError):
        return False


def load_into(path: str, like: Any) -> tuple[Any, dict]:
    """Load ``path`` into the structure of ``like`` (leaves matched by name):
    tensors take ``like``'s type and device, scalars its Python type.
    Returns ``(tree, meta)``; raises if any checksum fails."""
    manifest, arrays = _read(path)
    if not _verified(manifest, arrays):
        raise ValueError(f"checkpoint {path} fails checksum verification")

    def leaf(name: str, ref: Any) -> Any:
        if isinstance(ref, torch.Tensor):
            t = (_bf16(arrays[name + _BF16]) if name + _BF16 in arrays
                 else torch.from_numpy(np.array(arrays[name])))
            return t.to(device=ref.device, dtype=ref.dtype)
        a = arrays[name]
        if isinstance(ref, (bool, np.bool_)):
            return bool(a)
        if isinstance(ref, int):
            return int(a)
        if isinstance(ref, float):
            return float(a)
        return np.array(a)

    return tree_unflatten_like(like, leaf), manifest.get("meta", {})


def _verified(manifest: dict, arrays: dict[str, np.ndarray]) -> bool:
    if sorted(arrays) != manifest["keys"]:
        return False
    return all(
        hashlib.md5(np.ascontiguousarray(v).tobytes()).hexdigest()
        == manifest["checksums"][k]
        for k, v in arrays.items()
    )


def load_pytree(path: str, prefix: str = "", device="cuda") -> tuple[dict, dict]:
    """Load the sub-tree under ``prefix`` (e.g. ``"params"`` of a training
    checkpoint) as a nested dict of tensors; returns ``(tree, meta)``.
    Raises if any checksum fails."""
    dev = resolve_device(device)
    manifest, arrays = _read(path)
    if not _verified(manifest, arrays):
        raise ValueError(f"checkpoint {path} fails checksum verification")
    lead = prefix + "/" if prefix else ""
    flat = {}
    for key, a in arrays.items():
        name = key[: -len(_BF16)] if key.endswith(_BF16) else key
        if not name.startswith(lead):
            continue
        t = _bf16(a) if key.endswith(_BF16) else torch.from_numpy(a)
        flat[name[len(lead):]] = t.to(dev)
    if not flat:
        raise KeyError(f"no leaves under {prefix!r} in {path}")
    return unflatten(flat), manifest.get("meta", {})


def _steps(root: str) -> list[int]:
    return sorted(int(d[5:]) for d in os.listdir(root)
                  if d.startswith("step_") and d[5:].isdigit())


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:010d}")


def _latest_verified(root: str) -> Optional[int]:
    return next((s for s in reversed(_steps(root)) if verify(_step_dir(root, s))), None)


def restore_latest(
    root: str, prefix: str = "", device="cuda"
) -> Optional[tuple[dict, dict, int]]:
    """``(tree, meta, step)`` from the newest ``<root>/step_<N>/`` that
    verifies, or None when the directory holds no valid checkpoint."""
    step = _latest_verified(root)
    if step is None:
        return None
    tree, meta = load_pytree(_step_dir(root, step), prefix, device)
    return tree, meta, step


@dataclasses.dataclass
class Checkpointer:
    """Directory of checkpoints ``<root>/step_<N>/``, keeping the last
    ``keep_last`` and every multiple of ``keep_every``."""

    root: str
    keep_last: int = 3
    keep_every: Optional[int] = None

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)

    def step_dir(self, step: int) -> str:
        return _step_dir(self.root, step)

    def steps(self) -> list[int]:
        return _steps(self.root)

    def latest_step(self) -> Optional[int]:
        """The newest step whose checkpoint verifies."""
        return _latest_verified(self.root)

    def save(self, step: int, tree: Any, meta: Optional[dict] = None) -> str:
        path = self.step_dir(step)
        save_pytree(path, tree, {"step": step, **(meta or {})})
        self._gc()
        return path

    def load(self, like: Any, step: Optional[int] = None) -> tuple[Any, dict]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {self.root}")
        return load_into(self.step_dir(step), like)

    def _gc(self) -> None:
        steps = self.steps()
        keep = set(steps[-self.keep_last:])
        if self.keep_every:
            keep |= {s for s in steps if s % self.keep_every == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.step_dir(s), ignore_errors=True)


def carry_over(tree: dict, device="cuda", dtype=None) -> dict:
    """The port's tree from a JAX tree given as nested dicts of numpy arrays.

    Compressed leaves come as ``(values, indices, n, m, group_axis, shape,
    pad)`` tuples and become :class:`CompressedTensor`.  The stacked
    ``body`` layout ``(L, ...)`` is kept as it is.  ``dtype`` casts every
    floating leaf (compressed values included), e.g. to f32 for parity
    tests.
    """
    dev = resolve_device(device)

    def conv(x: Any):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple):
            values, indices, n, m, group_axis, shape, pad = x
            return CompressedTensor(
                numpy_to_torch(np.asarray(values), dev, dtype),
                numpy_to_torch(np.asarray(indices), dev),
                int(n), int(m), int(group_axis), tuple(shape), int(pad),
            )
        return numpy_to_torch(np.asarray(x), dev, dtype)

    return conv(tree)
