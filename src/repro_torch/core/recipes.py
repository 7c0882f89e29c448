"""Sparsity training recipes: dense / STE / SR-STE / ASP / Decaying-Mask /
STEP (counterpart of ``repro/core/recipes.py``).

A recipe decides (a) which weights the forward pass sees each step (masked
or not, straight-through or not) and (b) how the raw gradients are
post-processed (SR-STE's decay term).  The optimizer is chosen apart
(Adam, momentum SGD, or the STEP two-phase optimizer).

Every N:M mask, per step and at export, comes from ``kernels.nm_mask``:
the hand-written CUDA kernel for tensors on the card, its plain version for
tensors on the CPU.  The reference gates the mask work with ``lax.cond`` on
traced flags; here the flags are host values (the STEP phase flag, the
recipe's step count), so a step that needs no mask computes none.

A step's masks are a dict ``{leaf name: Masked(masked, mask)}`` over the
maskable leaves only; leaves absent from it see their dense weight (the
reference's ``ones`` mask), and an inactive step has an empty dict.
``masked`` is the kernel's ``Π⊙w``, which the STE forward uses directly.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import masking
from repro_torch.core.sparsity_config import SparsityConfig
from repro_torch.kernels import nm_mask as k4  # module: kernels.nm_mask imports core
from repro_torch.utils.tree import tree_items, tree_map_with_name

RECIPES = ("dense", "ste", "sr_ste", "asp", "decay", "step", "step_sr")


class Masked(NamedTuple):
    masked: Optional[torch.Tensor]  # Π⊙w of this step (None: form w * Π)
    mask: torch.Tensor  # Π, in the weight's type


class RecipeState(NamedTuple):
    step: int  # the recipe's own step count (robust to resume)
    fixed_mask: Optional[dict]  # ASP's one-shot mask tree (ones until pruned); None otherwise
    pruned: bool  # ASP latch


@torch.no_grad()
def mask_leaf(p: torch.Tensor, n: int, m: int, group_axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Π⊙w, Π)`` of one leaf through the ``nm_mask`` kernel, whose groups
    run down axis -2; another group axis is moved there and back."""
    axis = group_axis % p.ndim
    if axis == p.ndim - 2:
        return k4.nm_mask(p, n, m)
    masked, mask = k4.nm_mask(p.movedim(axis, -2).contiguous(), n, m)
    return masked.movedim(-2, axis), mask.movedim(-2, axis)


@dataclasses.dataclass(frozen=True)
class Recipe:
    """A sparsity training recipe bound to a SparsityConfig.

    kind:
      dense    — no masking ever.
      ste      — mask every step, straight-through gradients (Eq. 8).
      sr_ste   — ste + λ(1−Π)⊙w gradient decay (Eq. 9).
      asp      — dense until ``prune_at``; then a one-shot magnitude mask,
                 frozen, with true masked gradients.
      decay    — dense until ``dense_until``; then STE with N decaying
                 (M-1) → M/2 → M/4 → … → target N every ``decay_interval``.
      step     — mask only in the optimizer's phase 2 (Algorithm 1), STE.
      step_sr  — STEP whose phase-2 gradients also carry the SR-STE term.
    """

    kind: str = "step"
    sparsity: SparsityConfig = dataclasses.field(default_factory=SparsityConfig)
    sr_lambda: float = 2e-4
    prune_at: int = 0
    dense_until: int = 0
    decay_interval: int = 100

    def __post_init__(self):
        if self.kind not in RECIPES:
            raise ValueError(f"unknown recipe {self.kind!r}; choose from {RECIPES}")

    # -- state ---------------------------------------------------------------

    def init_state(self, params: dict) -> RecipeState:
        fixed = (tree_map_with_name(lambda _, p: torch.ones_like(p), params)
                 if self.kind == "asp" else None)
        return RecipeState(step=0, fixed_mask=fixed, pruned=False)

    # -- masks ---------------------------------------------------------------

    def _mask_tree(self, params: dict, n_override: Optional[int] = None) -> dict:
        """``{name: Masked}`` for every maskable leaf."""
        out = {}
        for name, p in tree_items(params):
            pat = self.sparsity.pattern_for(name, tuple(p.shape))
            if pat is None:
                continue
            n = pat.n if n_override is None else min(max(n_override, pat.n), pat.m)
            out[name] = Masked(*mask_leaf(p, n, pat.m, pat.group_axis))
        return out

    def _decay_n(self, t: int, m: int) -> int:
        """Kao et al.'s schedule: N = M-1, then ⌊M/2^i⌋, floored at the
        target N per leaf (in :meth:`_mask_tree`)."""
        i = max(0, (t - self.dense_until) // self.decay_interval)
        return m - 1 if i == 0 else max(1, m // 2 ** min(i, 30))

    def masks_for_step(self, params: dict, state: RecipeState,
                       phase2: bool) -> tuple[dict, bool, RecipeState]:
        """``(masks, active, new_state)`` for this step.  ``phase2`` is the
        STEP optimizer's phase flag entering the step (read by the STEP
        kinds only)."""
        t, kind = state.step, self.kind
        nxt = state._replace(step=t + 1)
        if kind == "dense":
            return {}, False, nxt
        if kind in ("ste", "sr_ste"):
            return self._mask_tree(params), True, nxt
        if kind in ("step", "step_sr"):
            return (self._mask_tree(params) if phase2 else {}), bool(phase2), nxt
        if kind == "decay":
            if t < self.dense_until:
                return {}, False, nxt
            pats = [self.sparsity.pattern_for(name, tuple(p.shape))
                    for name, p in tree_items(params)]
            m_global = max([p.m for p in pats if p is not None] or [4])
            return self._mask_tree(params, n_override=self._decay_n(t, m_global)), True, nxt
        if kind == "asp":
            fixed = state.fixed_mask
            if not state.pruned and t >= self.prune_at:
                masks = self._mask_tree(params)
                fixed = tree_map_with_name(
                    lambda name, old: masks[name].mask if name in masks else old, fixed)
            pruned = state.pruned or t >= self.prune_at
            new = RecipeState(step=t + 1, fixed_mask=fixed, pruned=pruned)
            if not pruned:
                return {}, False, new
            names = {n for n, p in tree_items(params)
                     if self.sparsity.pattern_for(n, tuple(p.shape)) is not None}
            return ({n: Masked(None, mk) for n, mk in tree_items(fixed) if n in names},
                    True, new)
        raise AssertionError(kind)

    def forward_params(self, params: dict, masks: dict, active: bool) -> dict:
        """The weights fed to the model this step (Eq. 8's Π⊙w)."""
        if self.kind == "dense" or not active:
            return params

        def leaf(name, p):
            if name not in masks:
                return p
            masked, mask = masks[name]
            if self.kind == "asp":  # true masked gradient: pruned weights stay dead
                return masking.masked_no_ste(p, mask)
            # STE family: the kernel's Π⊙w forward, the full gradient to w
            return masking.straight_through(p, masked)

        return tree_map_with_name(leaf, params)

    @torch.no_grad()
    def grad_postprocess(self, grads: dict, params: dict, masks: dict,
                         active: bool) -> dict:
        """Add the SR-STE term λ(1−Π)⊙w where the recipe has one (Eq. 9).
        The reference adds a zero term to unmasked leaves; here they keep
        their gradient as it is."""
        if self.kind not in ("sr_ste", "step_sr") or not active:
            return grads
        flat = dict(tree_items(params))

        def leaf(name, g):
            if name not in masks:
                return g
            term = masking.sr_ste_grad_term(flat[name].float(), masks[name].mask,
                                            self.sr_lambda)
            return g + term.to(g.dtype)

        return tree_map_with_name(leaf, grads)

    # -- export ---------------------------------------------------------------

    def final_masks(self, params: dict) -> dict:
        """Π_T for inference (Algorithm 1, line 23): the N:M mask of every
        maskable leaf, ones elsewhere."""
        masks = {} if self.kind == "dense" else self._mask_tree(params)
        return tree_map_with_name(
            lambda name, p: masks[name].mask if name in masks else torch.ones_like(p), params)

    def export_sparse(self, params: dict) -> dict:
        """Π_T ⊙ w_T, the deployable sparse model (Algorithm 1, line 24):
        the kernel's ``where(Π, w, 0)``, so pruned entries are ``+0.0``."""
        masks = {} if self.kind == "dense" else self._mask_tree(params)
        return tree_map_with_name(
            lambda name, p: masks[name].masked if name in masks else p, params)


def make_recipe(kind: str, sparsity: Optional[SparsityConfig] = None, **kw) -> Recipe:
    return Recipe(kind=kind, sparsity=sparsity or SparsityConfig(), **kw)
