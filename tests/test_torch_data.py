"""The port's synthetic LM data: the reference's Markov chain bit for bit,
labels shifted by one, batches a pure function of (seed, step), and an
iterator that resumes where its state says."""
import numpy as np
import pytest

from repro.data import SyntheticLMDataset as JaxDataset
from repro_torch.data import DataIterator, IteratorState, SyntheticLMDataset


@pytest.mark.parametrize("seed,n_states", [(42, 16), (0, 64)])
def test_chain_is_the_reference_chain(seed, n_states):
    ours = SyntheticLMDataset(vocab=256, seq_len=8, seed=seed, n_states=n_states)._chain()
    ref = JaxDataset(vocab=256, seq_len=8, seed=seed, n_states=n_states)._chain()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(ours.sum(axis=1), 1.0, rtol=1e-12)


def test_batches_are_pure_shifted_and_follow_the_chain():
    ds = SyntheticLMDataset(vocab=12, seq_len=64, seed=42, n_states=16)
    b = ds.batch(3, 8)
    assert b["tokens"].shape == b["labels"].shape == (8, 64)
    assert b["tokens"].dtype == b["labels"].dtype == np.int32
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    np.testing.assert_array_equal(b["labels"][:, -1], b["tokens"][:, 0])
    np.testing.assert_array_equal(ds.batch(3, 8)["tokens"], b["tokens"])
    assert not np.array_equal(ds.batch(4, 8)["tokens"], b["tokens"])
    assert b["tokens"].max() < 12  # states folded into the vocabulary
    # transitions follow the chain: no step the chain gives probability < 1e-9
    big = SyntheticLMDataset(vocab=256, seq_len=256, seed=42, n_states=16)
    toks = big.batch(0, 16)["tokens"]
    probs = big._chain()[toks[:, :-1], toks[:, 1:]]
    assert probs.min() > 1e-9


@pytest.mark.parametrize("prefetch", [0, 2])
def test_iterator_resumes_from_its_state(prefetch):
    ds = SyntheticLMDataset(vocab=64, seq_len=8, seed=1, n_states=16)
    it = DataIterator(batch_fn=ds.batch, batch_size=2, prefetch=prefetch)
    first = [next(it)["tokens"] for _ in range(5)]
    assert it.get_state() == IteratorState(0, 5)
    it.set_state(IteratorState(0, 2))
    again = [next(it)["tokens"] for _ in range(3)]
    it.close()
    for a, b in zip(first[2:], again):
        np.testing.assert_array_equal(a, b)
    for i, a in enumerate(first):
        np.testing.assert_array_equal(a, ds.batch(i, 2)["tokens"])
