"""Architecture registry: ``get_config(name)`` / ``list_archs()``.

All eleven of the reference's archs: the paper's gpt2-paper, the dense
starcoder2-3b, minitron-4b, command-r-plus-104b and qwen1.5-110b, the MoE
deepseek-v2-lite-16b (MLA) and dbrx-132b, the attention-free mamba2-2.7b
(Mamba-2 SSD), the hybrid recurrentgemma-9b, and the two with stub
frontends, qwen2-vl-2b (M-RoPE, patch embeddings) and musicgen-large (frame
embeddings).  ``get_config(name, smoke=True)`` gives the reduced
same-family variant.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, reduced
from repro_torch.configs.command_r_plus_104b import CONFIG as _command_r
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _deepseek
from repro_torch.configs.gpt2_paper import CONFIG as _gpt2
from repro_torch.configs.mamba2_27b import CONFIG as _mamba2
from repro_torch.configs.minitron_4b import CONFIG as _minitron
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2vl
from repro_torch.configs.qwen15_110b import CONFIG as _qwen15
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2

_REGISTRY: dict[str, ArchConfig] = {
    c.name: c for c in (_starcoder2, _qwen15, _minitron, _command_r, _deepseek, _dbrx,
                        _mamba2, _musicgen, _qwen2vl, _rgemma, _gpt2)
}


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {list_archs()}"
        )
    cfg = _REGISTRY[name]
    return reduced(cfg) if smoke else cfg
