"""Layer-wise mixed N:M assignment, DominoSearch-style (counterpart of
``repro/core/domino.py``; the paper's Table 4).

DominoSearch (Sun et al., 2021) finds a per-layer N with a shared M that
meets a global sparsity budget.  This is the greedy energy variant the
paper combines STEP with: from dense, repeatedly take one off the N of the
leaf that loses the least squared-magnitude energy per parameter removed,
until the kept parameters meet the budget.  STEP does not change the
assignment (paper §6, Ablation I), so the result is a ``SparsityConfig``
whose ``layer_patterns`` pin each maskable leaf to its N:M.

Each leaf's energy curve (the share of its squared magnitude an n:m mask
keeps, n = 0..m) comes from one sort of its groups on the leaf's own
device, a stacked leaf one slice of its leading axis at a time, summed in
float64.  The greedy choice, its tie-breaking (cost, then leaf name, then
n) and the emitted patterns are the reference's.
"""
from __future__ import annotations

import heapq
import re

import torch

from repro_torch.core.masking import NMSparsity
from repro_torch.core.sparsity_config import SparsityConfig
from repro_torch.utils.tree import tree_flatten_named


def energy_curve(w: torch.Tensor, m: int, axis: int) -> list[float]:
    """The share of ``w``'s squared magnitude (squares in f32, as the
    reference) that an n:m mask along ``axis`` keeps, for n = 0..m."""
    axis %= w.dim()
    parts = w.unbind(0) if w.dim() >= 3 and axis != 0 else (w,)
    if len(parts) > 1:
        axis -= 1
    kept = torch.zeros(m, dtype=torch.float64, device=w.device)
    for part in parts:
        sq = part.float().movedim(axis, -1).reshape(-1, m).square()
        kept += sq.sort(dim=-1, descending=True).values.sum(0, dtype=torch.float64)
    cum = torch.cat([kept.new_zeros(1), kept.cumsum(0)])
    return (cum / (cum[-1] + 1e-30)).tolist()


def domino_search(params: dict, base: SparsityConfig, m: int = 8,
                  target_density: float = 0.5, min_n: int = 1) -> SparsityConfig:
    """Per-leaf N:m patterns whose kept parameters meet ``target_density``
    of all maskable parameters (e.g. 0.25 for the paper's "Mixed N:8" at a
    2:8 average).  A maskable leaf (``base``'s policy) whose group axis does
    not divide by ``m`` keeps ``base``'s pattern; ``base`` comes back as it
    is if no leaf qualifies."""
    layers = []  # (name, weight, axis, size), in the reference's leaf order
    for name, p in tree_flatten_named(params):
        pat = base.pattern_for(name, tuple(p.shape))
        if pat is None or p.shape[pat.group_axis % p.dim()] % m:
            continue
        layers.append((name, p, pat.group_axis, p.numel()))
    if not layers:
        return base

    total = sum(size for *_, size in layers)
    budget = target_density * total
    n_cur = {name: m for name, *_ in layers}
    kept = float(total)
    energy = {name: energy_curve(w, m, axis) for name, w, axis, _ in layers}
    sizes = {name: size for name, _, _, size in layers}

    def cost(name: str, n_from: int) -> float:
        """Energy lost per parameter removed by taking ``n_from`` to ``n_from - 1``."""
        return (energy[name][n_from] - energy[name][n_from - 1]) / max(sizes[name] / m, 1.0)

    heap = [(cost(name, m), name, m) for name, *_ in layers]
    heapq.heapify(heap)
    while kept > budget and heap:
        _, name, n_from = heapq.heappop(heap)
        if n_cur[name] != n_from or n_from <= min_n:
            continue  # stale entry
        n_cur[name] = n_from - 1
        kept -= sizes[name] / m
        if n_cur[name] > min_n:
            heapq.heappush(heap, (cost(name, n_cur[name]), name, n_cur[name]))

    return SparsityConfig(
        default=base.default,
        layer_patterns=tuple((f"^{re.escape(name)}$", NMSparsity(n_cur[name], m, axis))
                             for name, _, axis, _ in layers),
        extra_excludes=base.extra_excludes,
        min_dim=base.min_dim,
    )


def assigned_ratios(cfg: SparsityConfig) -> dict[str, str]:
    """Leaf name -> its ``n:m``, from a :func:`domino_search` config."""
    return {regex.strip("^$").replace("\\", ""): str(p) for regex, p in cfg.layer_patterns}
