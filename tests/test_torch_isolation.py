"""The port stands alone: it imports nothing of JAX, flax, yaml, PIL or the JAX package (the
machine with the card has none of them), and its entry points never fall back to the CPU on
their own."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from foley_tpu_torch.configs import TINY, ClapTextConfig
from foley_tpu_torch.core.device import resolve_device
from foley_tpu_torch.models import clap, dac_vae, mmdit, siglip2, synchformer

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "yaml", "PIL", "foley_tpu"}


def _port_sources():
    return sorted((ROOT / "foley_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import foley_tpu_torch\n"
        "for m in pkgutil.walk_packages(foley_tpu_torch.__path__, 'foley_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_entry_points_need_a_device_without_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda")
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mmdit.init(TINY.model, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dac_vae.init(TINY.dac, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        siglip2.init_random(0, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synchformer.init_random(0, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clap.init(ClapTextConfig.tiny(), torch.Generator())
    assert resolve_device("cpu") == torch.device("cpu")


def _smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env=env)


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card; the smoke run is the chip's own check")
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
