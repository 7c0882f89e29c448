"""Architecture configuration (counterpart of ``repro/configs/base.py``).

Plain dataclasses of the reference's fields that the port reads.  The
reference module imports ``repro.models.*`` (and so JAX) for its MoE, MLA,
SSM and RG-LRU sub-configs; the port keeps its own copies,
:class:`MoEConfig` (``repro/models/moe.py:33``), :class:`MLAConfig`
(``repro/models/mla.py:26``), :class:`SSMConfig`
(``repro/models/ssm.py:24``) and :class:`RGLRUConfig`
(``repro/models/recurrent.py:23``).  ``frontend`` names the stub
frontend of the ``vlm`` and ``audio`` families (``vision_stub``: 1176-d
patch embeddings, ``audio_stub``: 512-d frame embeddings, projected to
``d_model`` by ``frontend/frontend_proj``).  The one field of the
reference the port leaves out is ``sub_quadratic`` (the reference's
long-context cell).  ``models.model.layer_plan`` raises for hybrid
patterns with other kinds than ``rec``/``attn`` and windows on MLA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # DeepSeek-style always-on shared experts
    capacity_factor: float = 1.25
    first_layer_dense: bool = False  # DeepSeek: layer 0 uses a dense MLP


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int  # recurrence width (RecurrentGemma: == d_model)
    conv_width: int = 4
    c: float = 8.0  # Griffin's fixed scaling constant


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # hybrid layer pattern, e.g. ("rec", "rec", "attn"); None = all-attn
    # (or all-ssm when family == "ssm")
    layer_pattern: Optional[Sequence[str]] = None
    frontend: str = "none"  # none | audio_stub | vision_stub
    param_dtype: str = "bfloat16"
    source: str = ""  # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def block_kinds(self) -> list[str]:
        """Per-layer block kinds, length ``n_layers``: the pattern repeated
        (and cut short), or all ``ssm`` (the SSM family) or ``attn``."""
        if self.layer_pattern is None:
            return ["ssm" if self.family == "ssm" else "attn"] * self.n_layers
        pat = list(self.layer_pattern)
        return [pat[i % len(pat)] for i in range(self.n_layers)]


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family variant for CPU tests (the reference's dims)."""
    n_kv = min(cfg.n_kv, 2)
    base = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.layer_pattern is None
                     else 2 * len(cfg.layer_pattern)),
        d_model=64,
        n_heads=max(4, n_kv * 2),
        n_kv=n_kv,
        d_ff=128,
        vocab=256,
        head_dim=16,
    )
    if cfg.moe is not None:
        base["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=32,
            n_shared=min(cfg.moe.n_shared, 1),
            capacity_factor=8.0,  # no token dropping in the tiny models
        )
    if cfg.mla is not None:
        base["mla"] = MLAConfig(kv_lora=32, rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
        base["head_dim"] = None
    if cfg.ssm is not None:
        base["ssm"] = SSMConfig(d_state=16, head_dim=8, expand=2, n_groups=1, conv_width=4,
                                chunk=8)
    if cfg.rglru is not None:
        base["rglru"] = RGLRUConfig(lru_width=64, conv_width=4)
    if cfg.local_window is not None:
        base["local_window"] = 16
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
