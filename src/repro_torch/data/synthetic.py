"""Deterministic synthetic data (counterpart of ``repro/data/synthetic.py``).

- :class:`SyntheticLMDataset`: tokens follow a fixed, randomly drawn
  first-order Markov chain over ``n_states`` symbols, so a model really can
  reduce its loss below ln(V).  The chain is the reference's, bit for bit
  (the same numpy draws).
- :class:`SyntheticTask`: the teacher-student task whose teacher is
  exactly N:M sparse, so a sparse student can represent it exactly.
- :func:`make_batch_specs`: shape and dtype stand-ins of a training batch.

A batch is a pure function of ``(seed, step)``, so any batch can be made
again after a restart.  Draws come from numpy's seeded generators, not
``jax.random``, so the numbers are not the reference's (parity tests feed
JAX-made weights and batches to both).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    seed: int = 0
    n_states: int = 64  # Markov-chain state count (<= vocab)

    def _chain(self) -> np.ndarray:
        """Row-stochastic transition matrix (n_states, n_states), fixed."""
        rng = np.random.default_rng(self.seed)
        logits = rng.normal(size=(self.n_states, self.n_states)) * 2.0
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        return p / p.sum(axis=1, keepdims=True)

    def batch(self, step: int, batch_size: int) -> dict:
        """Batch ``step`` as int32 numpy arrays ``tokens`` and ``labels``
        (the tokens shifted left by one, the first token wrapping to the
        end, as in the reference)."""
        rng = np.random.default_rng([self.seed, step])
        cum = np.cumsum(self._chain(), axis=1)
        state = rng.integers(0, self.n_states, batch_size)
        u = rng.random((self.seq_len, batch_size))
        seq = np.empty((batch_size, self.seq_len), np.int64)
        for i in range(self.seq_len):  # the first token is drawn from state0
            state = np.minimum((cum[state] < u[i, :, None]).sum(axis=1), self.n_states - 1)
            seq[:, i] = state
        tokens = (seq % self.vocab).astype(np.int32)
        return {"tokens": tokens,
                "labels": np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)}


@dataclasses.dataclass(frozen=True)
class SyntheticTask:
    """Teacher-student regression whose teacher is *exactly* N:M sparse, so
    the gap of a sparse recipe to dense comes from optimization (the
    paper's regime), not from capacity.  Tensors are f32 on ``device``: the
    card unless the caller asks for the CPU."""

    in_dim: int = 64
    out_dim: int = 32
    hidden: int = 128
    n: int = 2
    m: int = 4
    seed: int = 0
    noise: float = 0.01
    heavy_tail: bool = True  # gradient noise profile that stresses Adam's v
    device: str = "cuda"

    def _normal(self, rng: np.random.Generator, shape) -> torch.Tensor:
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            resolve_device(self.device))

    def teacher(self) -> dict:
        """``{"w1": (in, hidden), "w2": (hidden, out)}``: Gaussian weights
        N:M-masked along their input axis, scaled by 1/sqrt(fan-in)."""
        from repro_torch.core.masking import nm_mask

        rng = np.random.default_rng([self.seed, 0])
        w1 = self._normal(rng, (self.in_dim, self.hidden))
        w2 = self._normal(rng, (self.hidden, self.out_dim))
        w1 = w1 * nm_mask(w1, self.n, self.m, 0)
        w2 = w2 * nm_mask(w2, self.n, self.m, 0)
        return {"w1": w1 / self.in_dim ** 0.5, "w2": w2 / self.hidden ** 0.5}

    def student_init(self, seed: int = 0) -> dict:
        rng = np.random.default_rng([self.seed, 1, seed])
        return {"fc1": {"w": self._normal(rng, (self.in_dim, self.hidden)) * 0.05},
                "fc2": {"w": self._normal(rng, (self.hidden, self.out_dim)) * 0.05}}

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ params["fc1"]["w"]) @ params["fc2"]["w"]

    def batch(self, step: int, batch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``(x, y)``: Gaussian inputs and the teacher's outputs plus noise,
        one sample in 20 (on average) with 21 times the noise where
        ``heavy_tail`` (the heavy-tailed gradient noise under which Adam
        beats SGD and the paper's variance pathology shows)."""
        t = self.teacher()
        rng = np.random.default_rng([self.seed, 2, step])
        x = self._normal(rng, (batch_size, self.in_dim))
        y = torch.relu(x @ t["w1"]) @ t["w2"]
        noise = self.noise * self._normal(rng, tuple(y.shape))
        if self.heavy_tail:
            spike = torch.from_numpy(rng.random((batch_size, 1)) < 0.05).to(noise.device)
            noise = noise * (1.0 + 20.0 * spike.float())
        return x, y + noise

    def loss(self, params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return (self.apply(params, x) - y).square().mean()


def make_batch_specs(cfg: ArchConfig, batch_size: int, seq_len: int) -> dict:
    """Stand-ins of a training batch, as tensors on the ``meta`` device (shape
    and dtype, no storage): int32 ``labels`` (B, S) and int32 ``tokens``
    (B, S), or bf16 ``embeds`` (B, S, ``frontend_dim``) for an arch with a
    stub frontend."""
    from repro_torch.models.model import frontend_dim

    specs = {"labels": torch.empty((batch_size, seq_len), dtype=torch.int32, device="meta")}
    if cfg.frontend != "none":
        specs["embeds"] = torch.empty((batch_size, seq_len, frontend_dim(cfg)),
                                      dtype=torch.bfloat16, device="meta")
    else:
        specs["tokens"] = torch.empty((batch_size, seq_len), dtype=torch.int32, device="meta")
    return specs
