"""Architecture registry: ``get_config(name)`` / ``list_archs()``.

``gpt2-paper``, ``deepseek-v2-lite-16b`` and ``recurrentgemma-9b`` are
ported; the reference's other archs are listed in ROADMAP.md as still to
port.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, reduced
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _deepseek
from repro_torch.configs.gpt2_paper import CONFIG as _gpt2
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma

_REGISTRY: dict[str, ArchConfig] = {c.name: c for c in (_gpt2, _deepseek, _rgemma)}


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"arch {name!r} is not ported to repro_torch yet (see ROADMAP.md); "
            f"available: {list_archs()}"
        )
    cfg = _REGISTRY[name]
    return reduced(cfg) if smoke else cfg
