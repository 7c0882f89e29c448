"""The port stands alone: it imports neither JAX nor the ``repro`` package,
and its entry points refuse to run on a missing card instead of falling
back to the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# `import jax`, `from jax...`, `import repro`, `from repro.x` — but not repro_torch
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?![\w])", re.M)


def test_port_modules_import_without_jax_or_reference():
    code = (
        "import pkgutil, sys, repro_torch, repro_torch.launch.serve, repro_torch.launch.train\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True, cwd=ROOT)


def test_sources_name_no_jax_or_reference_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not offenders, offenders
    assert not _FORBIDDEN.search("from repro_torch.models import model")
    assert _FORBIDDEN.search("from repro.models import model")


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models.model import init_cache, init_params
    from repro_torch.serving import DecodeEngine

    cfg = get_config("gpt2-paper", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        DecodeEngine(cfg, init_params(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--batch", "1", "--gen", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "deepseek-v2-lite-16b", "--batch", "1", "--gen", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "recurrentgemma-9b", "--batch", "1", "--gen", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--steps", "1"])
    from repro_torch.launch.mesh import make_local_mesh, run_ranks

    with pytest.raises(RuntimeError, match="cuda"):
        make_local_mesh(1, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        run_ranks(print, model=2)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--batch", "1", "--gen", "2", "--paged", "--mesh", "1,2"])
