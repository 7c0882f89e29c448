"""Shared helpers of the ``test_torch_*`` parity tests: the same reduced
model (gpt2-paper by default, DeepSeek-V2-Lite or RecurrentGemma-9B) built
once in the JAX package and handed to the PyTorch port through
``repro_torch.checkpoint.carry_over``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core as jcore
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models.model import TransformerLM
from repro.sparse_infer import CompressedTensor as JaxCompressed
from repro.sparse_infer import compress_params as jax_compress_params
from repro_torch import core as tcore
from repro_torch.checkpoint import carry_over
from repro_torch.configs import get_config, reduced
from repro_torch.models import model as tmodel
from repro_torch.sparse_infer import compress as tcompress
from repro_torch.sparse_infer import export_compressed

# Cross-framework checks run in f32 on both sides: the two frameworks round
# bf16 at different places, so bf16 parity would test rounding, not the port.
F32 = dict(param_dtype="float32")
# f32 logits of the reduced model agree to ~1e-6 between the frameworks
# (different summation orders in matmul, attention and N:M reductions).
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
# A greedy token may differ only where the top-2 logits lie within this
# margin: a reordered f32 sum can flip a near-tie, nothing else can.
MARGIN = 1e-3


def configs(arch="gpt2-paper", **overrides):
    """(JAX cfg, port cfg) of the reduced ``arch`` in f32; ``overrides``
    go to both packages' ``reduced`` (e.g. ``n_layers``)."""
    return (dataclasses.replace(jax_reduced(jax_get_config(arch), **overrides), **F32),
            dataclasses.replace(reduced(get_config(arch), **overrides), **F32))


def to_numpy(tree):
    """A JAX tree as nested dicts of numpy, compressed leaves as
    ``(values, indices, n, m, group_axis, shape, pad)``."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, JaxCompressed):
        return (np.asarray(tree.values), np.asarray(tree.indices), tree.n, tree.m,
                tree.group_axis, tree.shape, tree.pad)
    return np.asarray(tree)


def trees(seed=0, align=None, arch="gpt2-paper", **overrides):
    """``(jcfg, tcfg, {"dense"|"compressed": (jax_tree, port_tree)})`` —
    the STEP 2:4 export of one random init and its compressed artifact."""
    jcfg, tcfg = configs(arch, **overrides)
    model = TransformerLM(jcfg)
    recipe = jcore.make_recipe("step", jcore.SparsityConfig(default=jcore.NMSparsity(2, 4)))
    sparse = recipe.export_sparse(model.init(jax.random.PRNGKey(seed)))
    comp = jax_compress_params(sparse, recipe.sparsity, align=align)
    return jcfg, tcfg, {
        "dense": (sparse, carry_over(to_numpy(sparse), device="cpu")),
        "compressed": (comp, carry_over(to_numpy(comp), device="cpu")),
    }


def port_tree(arch, **overrides):
    """``(port cfg, compressed tree)`` of the reduced ``arch`` in f32, made by
    the port alone (what a test of the port against itself needs)."""
    tcfg = configs(arch, **overrides)[1]
    recipe = tcore.make_recipe("step", tcore.SparsityConfig(default=tcore.NMSparsity(2, 4)))
    return tcfg, export_compressed(tmodel.init_params(tcfg, seed=0, device="cpu"), recipe)[0]


def to_jax(tree):
    """A port tree as the JAX package's: nested dicts of ``jnp`` arrays,
    compressed leaves as its ``CompressedTensor`` (the reverse of
    ``carry_over``; building a reduced tree in the port and carrying it over
    costs a fraction of the reference's eager init and export)."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, tcompress.CompressedTensor):
        return JaxCompressed(jnp.asarray(tree.values.numpy()), jnp.asarray(tree.indices.numpy()),
                             tree.n, tree.m, tree.group_axis, tuple(tree.shape), tree.pad)
    return jnp.asarray(tree.numpy())


def full_tables(lengths, ps, n_slots, num_pages):
    """Append-only tables: distinct pages for every lane's live prefix."""
    t = np.full((len(lengths), n_slots), num_pages, np.int32)
    nxt = 0
    for i, ln in enumerate(lengths):
        for pg in range(-(-ln // ps)):
            t[i, pg] = nxt % num_pages
            nxt += 1
    return t


def win_tables(lengths, ps, win, win_slots, num_pages, ahead=0):
    """Modular window tables as the pool keeps them: each lane's live
    window pages (plus ``ahead`` pages mapped past the current one, not yet
    written) at slot ``pg % win_slots``; every other slot is the sentinel."""
    t = np.full((len(lengths), win_slots), num_pages, np.int32)
    nxt = 0
    for i, ln in enumerate(lengths):
        if ln == 0:
            continue
        for pg in range(max(0, ln - win) // ps, (ln - 1) // ps + 1 + ahead):
            t[i, pg % win_slots] = nxt % num_pages
            nxt += 1
    return t


def prompts(n, vocab, lo=3, step=3, seed=100):
    return [np.random.default_rng(seed + r).integers(0, vocab, lo + step * r).tolist()
            for r in range(n)]


def assert_streams_agree(tcfg, tparams, prompt, a, b, margin=MARGIN):
    """Token streams ``a`` and ``b`` for ``prompt`` are equal, or first
    differ where the port's full-forward top-2 logit margin is below
    ``margin`` (a near-tie that reordered f32 sums may flip)."""
    j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if j is None:
        assert len(a) == len(b), (a, b)
        return
    toks = torch.tensor([prompt + list(a[:j])])
    logits, _ = tmodel.forward(tparams, tcfg, toks)
    top2 = torch.topk(logits[0, -1].float(), 2).values
    gap = float(top2[0] - top2[1])
    assert gap < margin, f"streams diverge at token {j} with top-2 margin {gap}: {a} vs {b}"
