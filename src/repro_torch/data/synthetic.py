"""Deterministic synthetic LM data (counterpart of ``SyntheticLMDataset`` in
``repro/data/synthetic.py``).

Tokens follow a fixed, randomly drawn first-order Markov chain over
``n_states`` symbols, so a model really can reduce its loss below ln(V).
The chain is the reference's, bit for bit (the same numpy draws).  A batch
is a pure function of ``(seed, step)``, so any batch can be made again
after a restart; it is drawn with numpy, not ``jax.random``, so its tokens
are not the reference's (parity tests feed JAX-made batches to both).
The reference's teacher-student ``SyntheticTask`` is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
