"""Which parameters get N:M-masked (counterpart of ``repro/core/sparsity_config.py``).

A leaf is maskable iff it is a >=2-D matmul weight with every grouped dim
>= M, excluding embeddings, norms, biases, routers and recurrence
parameters.  ``layer_patterns`` is a list of (regex, NMSparsity) tried in
order; non-matching maskable leaves use ``default``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

from repro_torch.core.masking import NMSparsity
from repro_torch.utils.tree import tree_items, tree_map_with_name

# name fragments that are never masked, whatever their shape
_EXCLUDE_FRAGMENTS = (
    "embed", "norm", "bias", "router", "scale", "a_log", "d_skip", "dt_",
    "conv", "gate_diag", "lambda",
)


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Global sparsity policy for a parameter tree."""

    default: NMSparsity = NMSparsity(2, 4)
    layer_patterns: Sequence[tuple[str, NMSparsity]] = ()
    extra_excludes: Sequence[str] = ()
    min_dim: Optional[int] = None  # both dims must be >= this (default: M)

    def pattern_for(self, name: str, shape: tuple[int, ...]) -> Optional[NMSparsity]:
        """The N:M pattern for a named leaf, or None if it must stay dense."""
        lname = name.lower()
        if any(f in lname for f in _EXCLUDE_FRAGMENTS):
            return None
        if any(f in lname for f in self.extra_excludes):
            return None
        if len(shape) < 2:
            return None
        pat = self.default
        for regex, p in self.layer_patterns:
            if re.search(regex, name):
                pat = p
                break
        if pat is None:
            return None
        # weights are (..., in, out) everywhere (stacked body: (L, in, out)),
        # so groups run along the contraction dim, axis -2; a configured
        # group_axis of 0 means "the reduction axis"
        if pat.group_axis == 0:
            pat = dataclasses.replace(pat, group_axis=-2)
        if shape[pat.group_axis % len(shape)] % pat.m != 0:
            return None  # group dim not divisible: stay dense
        floor = self.min_dim if self.min_dim is not None else pat.m
        if min(shape[-2:]) < floor:
            return None
        return pat


def maskable_map(params: dict, cfg: SparsityConfig) -> dict:
    """Tree of ``Optional[NMSparsity]``, aligned with ``params``."""
    return tree_map_with_name(lambda name, p: cfg.pattern_for(name, tuple(p.shape)), params)


def sparsity_report(params: dict, cfg: SparsityConfig) -> dict:
    """Coverage summary: parameter counts, the maskable share and the share
    of all parameters the masks remove, and each leaf's pattern."""
    total, masked, removed, per_leaf = 0, 0, 0.0, {}
    for name, p in tree_items(params):
        pat = cfg.pattern_for(name, tuple(p.shape))
        total += p.numel()
        if pat is not None:
            masked += p.numel()
            removed += p.numel() * (1 - pat.density)
            per_leaf[name] = str(pat)
        else:
            per_leaf[name] = "dense"
    return {
        "total_params": total,
        "maskable_params": masked,
        "maskable_fraction": masked / max(total, 1),
        "removed_fraction_of_total": removed / max(total, 1),
        "per_leaf": per_leaf,
    }
