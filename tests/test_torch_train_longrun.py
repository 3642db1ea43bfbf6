"""The port's long-run training tool (``foley_tpu_torch/tools/train_longrun.py``) against the
JAX tool (``tools/train_longrun.py``), on the CPU: the synthesized corpus is the JAX tool's,
WAV byte for WAV byte, and a short TINY run stays finite and deploys (its export loads and
generates finite audio). Neither this file nor ``chip_smoke.py``'s ``train_longrun`` phase
checks that the loss falls: at the tool's defaults the JAX tool itself reads ``ok`` false
(``ROADMAP.md``); the phase runs the tool on the card and reports its figures.
"""

import importlib.util
import os
import sys
import tempfile

import pytest

from foley_tpu_torch.tools import train_longrun
from torch_helpers import jax_native_library, one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Stop(Exception):
    pass


def _jax_corpus(tmp_path, monkeypatch) -> str:
    """The JAX tool's ``main`` run up to its corpus: its temporary directory made under
    ``tmp_path`` and the DAC's init stopping it once the WAVs are written."""
    from foley_tpu.models import dac_vae

    spec = importlib.util.spec_from_file_location("jax_train_longrun",
                                                  os.path.join(ROOT, "tools", "train_longrun.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    work = str(tmp_path / "jax")
    os.makedirs(work)
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix="": work)
    monkeypatch.setattr(sys, "argv", ["train_longrun.py"])

    def stop(*_, **__):
        raise _Stop

    monkeypatch.setattr(dac_vae, "init", stop)
    with pytest.raises(_Stop):
        tool.main()
    return os.path.join(work, "wavs")


def test_corpus_is_the_jax_tools_byte_for_byte(tmp_path, monkeypatch):
    ref_dir = _jax_corpus(tmp_path, monkeypatch)
    got_dir = str(tmp_path / "port")
    n = train_longrun.synthesize_corpus(got_dir, 1.0)
    assert n == 6 and sorted(os.listdir(got_dir)) == sorted(os.listdir(ref_dir))
    for name in os.listdir(ref_dir):
        with open(os.path.join(ref_dir, name), "rb") as a, \
                open(os.path.join(got_dir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_a_short_tiny_run_is_finite_and_deploys(capsys):
    assert train_longrun.main(["--num_steps", "12", "--device", "cpu"]) == 0
    import json

    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) >= {"loss_head", "loss_tail", "loss_drop_ratio", "finite", "deploy_ok",
                        "ok", "trajectory"}
    assert out["finite"] and out["deploy_ok"] and out["num_steps"] == 12
    assert out["trajectory"] == [[10, out["loss_tail"]]]  # logged every 10 steps
