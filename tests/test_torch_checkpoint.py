"""The port reads checkpoints written by ``repro.checkpoint.save_pytree``
bit-exact (bf16 through its uint16 view), verifies their checksums, and
carries JAX trees over bit-exact."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer, save_pytree
from repro_torch.checkpoint import carry_over, load_pytree, restore_latest
from torch_parity import to_numpy


def _tree(seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {
        "params": {
            "embed": {"tok_embed": jax.random.normal(k1, (16, 8), jnp.bfloat16)},
            "body": {"sb_0": {"attn": {"wq": jax.random.normal(k2, (2, 8, 8), jnp.float32)}}},
            "steps": jnp.arange(5, dtype=jnp.int32),
        },
        "opt": {"mu": jnp.ones((3,), jnp.float32)},
    }


def _same_bits(t: torch.Tensor, a) -> None:
    a = np.asarray(a)
    if t.dtype == torch.bfloat16:
        assert a.dtype.name == "bfloat16"
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    else:
        assert t.numpy().dtype == a.dtype
        np.testing.assert_array_equal(t.numpy(), a)


def test_load_pytree_bit_exact(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ck")
    save_pytree(path, tree, {"step": 7})
    got, meta = load_pytree(path, device="cpu")
    assert meta == {"step": 7}
    _same_bits(got["params"]["embed"]["tok_embed"], tree["params"]["embed"]["tok_embed"])
    _same_bits(got["params"]["body"]["sb_0"]["attn"]["wq"],
               tree["params"]["body"]["sb_0"]["attn"]["wq"])
    _same_bits(got["params"]["steps"], tree["params"]["steps"])
    sub, _ = load_pytree(path, prefix="params", device="cpu")
    assert sorted(sub) == ["body", "embed", "steps"]


def test_restore_latest_reads_newest_verified_params(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1))
    ck.save(2, _tree(2))
    # corrupt step 2: its checksum no longer verifies, so step 1 is read
    npz = os.path.join(ck._step_dir(2), "arrays.npz")
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["opt/mu"] = arrays["opt/mu"] + 1
    np.savez(npz, **arrays)
    with pytest.raises(ValueError, match="checksum"):
        load_pytree(ck._step_dir(2), device="cpu")
    params, _, step = restore_latest(str(tmp_path), prefix="params", device="cpu")
    assert step == 1
    _same_bits(params["embed"]["tok_embed"], _tree(1)["params"]["embed"]["tok_embed"])
    (tmp_path / "empty").mkdir()
    assert restore_latest(str(tmp_path / "empty"), device="cpu") is None


def test_carry_over_bit_exact_and_cast():
    tree = to_numpy(_tree()["params"])
    got = carry_over(tree, device="cpu")
    _same_bits(got["embed"]["tok_embed"], tree["embed"]["tok_embed"])
    f32 = carry_over(tree, device="cpu", dtype=torch.float32)
    assert f32["embed"]["tok_embed"].dtype == torch.float32
    assert f32["steps"].dtype == torch.int32  # integer leaves keep their type
