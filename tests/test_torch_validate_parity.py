"""The port's parity gate (``foley_tpu_torch/tools/validate_parity.py``) against the JAX tool
(``tools/validate_parity.py``), on the CPU: the same WAVs give the same printed figures and
exit codes (pass, fail, a sample-rate mismatch, another threshold), and ``--self_test``
passes through the port's CLI.
"""

import importlib.util
import os
import wave

import numpy as np
import pytest

from foley_tpu_torch.tools import validate_parity
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_validate_parity", os.path.join(ROOT, "tools", "validate_parity.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _wav(path, samples, rate=48000, channels=1):
    pcm = np.clip(samples * 32767, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    t = np.arange(24000) / 48000
    tone = 0.4 * np.sin(2 * np.pi * 330 * t)
    return {"a": _wav(d / "a.wav", tone),
            "near": _wav(d / "near.wav", tone + rng.normal(0, 1e-3, t.size)),
            "other": _wav(d / "other.wav", rng.normal(0, 0.2, t.size)),
            "stereo": _wav(d / "stereo.wav", np.repeat(tone, 2) * 0.9, channels=2),
            "rate": _wav(d / "rate.wav", tone, rate=16000)}


@pytest.mark.parametrize("pair,extra,rc", [
    (("a", "a"), [], 0), (("a", "near"), [], 0), (("a", "other"), [], 1),
    (("a", "stereo"), [], 0), (("a", "rate"), [], 2),
    (("a", "near"), ["--threshold", "0.9999999"], 1), (("other", "a"), ["--threshold", "-1"], 0)],
    ids=["same", "near", "other", "stereo", "rate", "strict", "any_threshold"])
def test_figures_and_exit_codes_match_the_jax_tool(jax_tool, wavs, capsys, pair, extra, rc):
    argv = [wavs[pair[0]], wavs[pair[1]], *extra]
    ref_rc = jax_tool.main(argv)
    ref = capsys.readouterr()
    got_rc = validate_parity.main(argv)
    got = capsys.readouterr()
    assert (got_rc, got.out, got.err) == (ref_rc, ref.out, ref.err)
    assert ref_rc == rc


def test_read_wav_matches_the_jax_tool(jax_tool, wavs):
    for path in wavs.values():
        a, b = jax_tool.read_wav(path), validate_parity.read_wav(path)
        assert a[1] == b[1] and np.array_equal(a[0], b[0])


def test_self_test_passes(capsys):
    assert validate_parity.main(["--self_test", "--device", "cpu"]) == 0
    assert "-> OK" in capsys.readouterr().out
