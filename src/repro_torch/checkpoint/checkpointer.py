"""Checkpoint load side and the JAX weight carry-over.

Counterpart of the load half of ``repro/checkpoint/checkpointer.py``.  A
checkpoint directory holds ``arrays.npz`` (one array per leaf, keyed by its
'/'-joined tree path; bf16 leaves stored as uint16 views under a ``::bf16``
suffix) and ``manifest.json`` (sorted keys plus an md5 per array).
``load_pytree`` verifies every checksum and rebuilds bf16 leaves bit-exact.

``carry_over`` feeds a JAX parameter tree, as numpy, to the port: the tests
use it to hand both packages the same weights.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.sparse_infer.compress import CompressedTensor
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import unflatten

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


def restore_latest(
    root: str, prefix: str = "", device="cuda"
) -> Optional[tuple[dict, dict, int]]:
    """``(tree, meta, step)`` from the newest ``<root>/step_<N>/`` that
    verifies, or None when the directory holds no valid checkpoint."""
    steps = sorted(
        int(d[5:]) for d in os.listdir(root)
        if d.startswith("step_") and d[5:].isdigit()
    )
    for step in reversed(steps):
        path = os.path.join(root, f"step_{step:010d}")
        manifest, arrays = _read(path)
        if _verified(manifest, arrays):
            tree, meta = load_pytree(path, prefix, device)
            return tree, meta, step
    return None


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
