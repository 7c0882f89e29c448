"""Architecture configuration (counterpart of ``repro/configs/base.py``).

A plain dataclass of the reference's fields that the port's dense family
reads.  The reference module imports ``repro.models.*`` (and so JAX) for its
MoE/MLA/SSM sub-configs; those families are not ported yet (ROADMAP.md), so
their fields are absent here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    o_bias: bool = False
    mlp: str = "swiglu"  # swiglu | gelu
    norm: str = "rms"  # rms | ln
    rope: str = "rope"  # rope | mrope | none
    rope_theta: float = 10000.0
    local_window: Optional[int] = None  # sliding-window attention
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    source: str = ""  # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family variant for CPU tests (the reference's dims)."""
    n_kv = min(cfg.n_kv, 2)
    base = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=max(4, n_kv * 2),
        n_kv=n_kv,
        d_ff=128,
        vocab=256,
        head_dim=16,
    )
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
