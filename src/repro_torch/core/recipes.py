"""Mask export of a sparsity recipe (counterpart of ``repro/core/recipes.py``).

Only the export side is ported: ``final_masks`` (Π_T, Algorithm 1 line 23)
and ``export_sparse`` (Π_T ⊙ w_T, line 24).  The training recipes come with
the training slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import masking
from repro_torch.core.sparsity_config import SparsityConfig
from repro_torch.utils.tree import tree_map_with_name

RECIPES = ("dense", "ste", "sr_ste", "asp", "decay", "step", "step_sr")


@dataclasses.dataclass(frozen=True)
class Recipe:
    kind: str = "step"
    sparsity: SparsityConfig = dataclasses.field(default_factory=SparsityConfig)

    def __post_init__(self):
        if self.kind not in RECIPES:
            raise ValueError(f"unknown recipe {self.kind!r}; choose from {RECIPES}")

    def _leaf_mask(self, name: str, p: torch.Tensor) -> torch.Tensor:
        pat = self.sparsity.pattern_for(name, tuple(p.shape))
        if self.kind == "dense" or pat is None:
            return torch.ones_like(p)
        return masking.nm_mask(p, pat.n, pat.m, pat.group_axis)

    def final_masks(self, params: dict) -> dict:
        """Π_T: the N:M mask of every maskable leaf, ones elsewhere."""
        return tree_map_with_name(self._leaf_mask, params)

    def export_sparse(self, params: dict) -> dict:
        """Π_T ⊙ w_T — the deployable sparse model."""
        return tree_map_with_name(
            lambda name, p: p * self._leaf_mask(name, p), params
        )


def make_recipe(kind: str, sparsity: Optional[SparsityConfig] = None) -> Recipe:
    return Recipe(kind=kind, sparsity=sparsity or SparsityConfig())
