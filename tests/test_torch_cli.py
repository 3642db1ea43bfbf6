"""The port's command line (``foley_tpu_torch/cli.py``) against the JAX package's
(``foley_tpu/cli.py``), on the CPU at the TINY config.

Both CLIs load one checkpoint directory (``--model_path``: the reference-layout denoiser of
``tests/test_io.py``, the DAC and a CLAP with a byte-level BPE tokenizer beside it, which
both packages read; no Synchformer, so both warn and go on). The initial noise is the JAX
draw, injected into the port (``jax.random`` and a ``torch.Generator`` give other bits for
one seed), as ``tests/test_torch_nodes.py`` does. Tolerance: the WAVs' int16 samples within
5 steps (the node tests' audio atol 1e-4 is 3.3 steps, and each side rounds to 16 bits).
"""

import io
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu import cli as jcli
from foley_tpu_torch import cli as tcli
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.pipeline import edit as tedit
from foley_tpu_torch.pipeline import generate as tgen
from foley_tpu_torch.pipeline import longform as tlong
from torch_helpers import jax_latents, one_torch_thread, save_checkpoint_dir  # noqa: F401
from torch_helpers import jax_native_library  # noqa: F401 (autouse)

PCM_TOL = 5  # int16 steps
RUN = ["--config", "tiny", "--single_prompt", "glass shattering", "--neg_prompt", "noisy harsh",
       "--num_inference_steps", "2", "--seed", "3"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_ckpts")
    save_checkpoint_dir(root)
    return root


def _inject_noise(monkeypatch, seed):
    """The JAX CLI's draws in the port: the sampler's and long-form's initial noise, the
    edit's renoising draw."""
    noise = jax_latents(seed)

    def edit_noise(gen, b, length, dim):
        return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                                           (b, length, dim), jnp.float32)))

    monkeypatch.setattr(tgen, "prepare_latents", noise)
    monkeypatch.setattr(tlong, "prepare_latents", noise)
    monkeypatch.setattr(tedit, "prepare_latents", edit_noise)


def _read(path):
    with wave.open(str(path)) as f:
        assert (f.getframerate(), f.getnchannels(), f.getsampwidth()) == (48000, 1, 2)
        return np.frombuffer(f.readframes(f.getnframes()), "<i2").astype(np.int32)


def _write_wav(path, seconds=1.0, channels=1, rate=48000, width=2, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = 0.3 * np.sin(2 * np.pi * 330 * t)[:, None] + 0.05 * rng.normal(size=(n, channels))
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(rate)
        if width == 2:
            f.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
        else:
            f.writeframes(b"\x00" * (width * channels * n))
    return str(path)


def _both(monkeypatch, tmp_path, argv):
    """Run ``argv`` through both CLIs, each writing its own WAV; returns (jax, port)."""
    out_j, out_t = tmp_path / "jax.wav", tmp_path / "port.wav"
    assert jcli.main(argv + ["--output", str(out_j)]) == 0
    _inject_noise(monkeypatch, 3)
    assert tcli.main(argv + ["--output", str(out_t), "--device", "cpu"]) == 0
    return _read(out_j), _read(out_t)


def test_t2a_matches_jax(model_dir, monkeypatch, tmp_path):
    ref, got = _both(monkeypatch, tmp_path,
                     ["--model_path", str(model_dir), "--duration", "1"] + RUN)
    assert got.shape == ref.shape == (48000,)
    assert np.abs(got - ref).max() <= PCM_TOL
    assert np.abs(got).max() > 0


def test_edit_matches_jax(model_dir, monkeypatch, tmp_path):
    src = _write_wav(tmp_path / "src.wav", seconds=1.0, seed=1)
    ref, got = _both(monkeypatch, tmp_path, ["--model_path", str(model_dir), "--audio_input",
                                             src, "--strength", "0.6"] + RUN)
    assert got.shape == ref.shape == (48000,)
    assert np.abs(got - ref).max() <= PCM_TOL


def test_continuation_matches_jax(model_dir, monkeypatch, tmp_path):
    src = _write_wav(tmp_path / "src.wav", seconds=1.0, channels=2, seed=2)
    ref, got = _both(monkeypatch, tmp_path,
                     ["--model_path", str(model_dir), "--continue_audio", src, "--duration",
                      "1", "--context_s", "0.5"] + RUN)
    assert got.shape == ref.shape == (48000,)
    assert np.abs(got - ref).max() <= PCM_TOL


def test_stream_pcm_matches_jax(model_dir, monkeypatch, capsysbinary):
    argv = ["--model_path", str(model_dir), "--duration", "3", "--stream_pcm",
            "--first_window", "1"] + RUN
    assert jcli.main(argv) == 0
    ref = np.frombuffer(capsysbinary.readouterr().out, "<i2").astype(np.int32)
    _inject_noise(monkeypatch, 3)
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = np.frombuffer(capsysbinary.readouterr().out, "<i2").astype(np.int32)
    assert got.shape == ref.shape == (3 * 48000,)
    assert np.abs(got - ref).max() <= PCM_TOL


def test_random_init_writes_the_wav(tmp_path):
    """The smoke route of the card's ``cli`` phase, here in fp16 on the CPU: a perturbed
    random TINY model, a 48 kHz mono WAV of the duration, non-silent."""
    out = tmp_path / "t2a.wav"
    assert tcli.main(["--random_init", "tiny", "--random_init_perturb", "--precision", "fp16",
                      "--duration", "1", "--num_inference_steps", "2", "--progress",
                      "--device", "cpu", "--output", str(out)]) == 0
    pcm = _read(out)
    assert pcm.shape == (48000,) and np.abs(pcm).max() > 0


def test_csv_batch(tmp_path):
    """Rows of ``video,prompt``: a row without a video generates (the same audio as the same
    run alone), a row whose video cannot be read (no ffmpeg on ``PATH``) fails and the batch
    goes on, returning 1; comments are skipped."""
    csv_path = tmp_path / "rows.csv"
    csv_path.write_text("# video,prompt\n,rain on a roof\nclip.mp4,thunder\n,wind\n")
    base = ["--random_init", "tiny", "--random_init_perturb", "--precision", "fp32",
            "--duration", "1", "--num_inference_steps", "2", "--seed", "0", "--device", "cpu"]
    assert tcli.main(base + ["--csv_path", str(csv_path), "--output",
                             str(tmp_path / "out.wav")]) == 1
    assert sorted(p.name for p in tmp_path.glob("out_*.wav")) == ["out_000.wav", "out_002.wav"]
    assert tcli.main(base + ["--single_prompt", "rain on a roof", "--output",
                             str(tmp_path / "alone.wav")]) == 0
    np.testing.assert_array_equal(_read(tmp_path / "out_000.wav"),
                                  _read(tmp_path / "alone.wav"))


@pytest.mark.parametrize("source", [["--random_init", "tiny"], ["--model_path", "ckpts"]])
def test_gradio_hands_the_server_the_jax_argv(monkeypatch, source):
    """``--gradio`` calls the server's ``main`` with the JAX CLI's argv mapping, plus the
    device."""
    from foley_tpu.serving import server as jserver
    from foley_tpu_torch.serving import server as tserver

    seen = {}
    monkeypatch.setattr(jserver, "main", lambda argv: seen.setdefault("jax", argv) and 0)
    monkeypatch.setattr(tserver, "main", lambda argv: seen.setdefault("port", argv) and 0)
    argv = ["--gradio", "--port", "9000", "--precision", "fp16", "--duration", "8",
            "--num_inference_steps", "20", "--max_batch", "2", "--config", "xl",
            "--quantization", "int8", "--blocks_to_swap", "30", "--prefetch_blocks", "1"] + source
    assert jcli.main(argv) == 0 and tcli.main(argv + ["--device", "cpu"]) == 0
    port = seen["port"]
    i = port.index("--device")
    assert port[i + 1] == "cpu"
    assert port[:i] + port[i + 2:] == seen["jax"]


@pytest.mark.parametrize("argv,item", [
    (["--merge_video", "--single_video", "FRAMES"], "avi"),
    (["--merge_video", "--single_video", "FRAMES", "--gradio"], "server"),
    (["--desync_score"], "requires --single_video"),
    (["--merge_video", "--single_video", "FRAMES", "--v2a_preprocess", "pil"], "avi")])
def test_refusals_name_their_roadmap_item(capsys, monkeypatch, tmp_path, argv, item):
    """Of what the port refused with exit 2 before any model work, the desync score without
    a video still is. ``--merge_video`` onto a frames directory now writes an MJPEG AVI beside
    the WAV, equal to the JAX package's muxer on the same frames and WAV; with ``--gradio``
    the server starts, as the JAX CLI's does (it muxes nothing there)."""
    from foley_tpu.io import avi as javi
    from foley_tpu_torch.serving import server as tserver
    from PIL import Image

    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(8)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (16, 20, 3), dtype=np.uint8)).save(
            frames / f"{i}.jpg", quality=90)
    argv = ["--random_init", "tiny", "--device", "cpu"] + [
        str(frames) if a == "FRAMES" else a for a in argv]
    if item == "server":
        seen = []
        monkeypatch.setattr(tserver, "main", lambda a: seen.append(a) or 0)
        assert tcli.main(argv) == 0 and len(seen) == 1
    elif item == "avi":
        out = tmp_path / "v2a.wav"
        assert tcli.main(argv + ["--frames_fps", "8", "--duration", "1",
                                 "--num_inference_steps", "2", "--output", str(out)]) == 0
        ref = javi.merge_frames_dir_audio(str(frames), str(out), str(tmp_path / "ref.mp4"),
                                          fps=8.0)
        assert (tmp_path / "v2a.avi").read_bytes() == open(ref, "rb").read()
    else:
        assert tcli.main(argv) == 2
        assert item in capsys.readouterr().err


def test_mesh_without_gradio_is_ignored(model_dir, monkeypatch, tmp_path):
    """``--mesh`` applies to ``--gradio`` alone: a one-shot run ignores it, as the JAX CLI
    does, and writes the same audio."""
    ref, got = _both(monkeypatch, tmp_path, ["--model_path", str(model_dir), "--duration", "1",
                                             "--mesh", "data=4"] + RUN)
    assert got.shape == ref.shape == (48000,)
    assert np.abs(got - ref).max() <= PCM_TOL


def test_gradio_passes_the_mesh_on(monkeypatch):
    """``--gradio --mesh`` hands the server the JAX CLI's argv, ``--mesh`` included."""
    from foley_tpu.serving import server as jserver
    from foley_tpu_torch.serving import server as tserver

    seen = {}
    monkeypatch.setattr(jserver, "main", lambda argv: seen.setdefault("jax", argv) and 0)
    monkeypatch.setattr(tserver, "main", lambda argv: seen.setdefault("port", argv) and 0)
    argv = ["--gradio", "--random_init", "tiny", "--v2a_preprocess", "pil", "--mesh", "data=4"]
    assert jcli.main(argv) == 0 and tcli.main(argv + ["--device", "cpu"]) == 0
    port = seen["port"]
    i = port.index("--device")
    assert port[:i] + port[i + 2:] == seen["jax"]
    assert port[port.index("--mesh") + 1] == "data=4"


def test_gradio_mesh_with_block_swap_is_refused_as_jax(capsys):
    """``--gradio --mesh`` with ``--blocks_to_swap``: the server refuses it before any load,
    with the JAX server's message, through either CLI."""
    argv = ["--gradio", "--random_init", "tiny", "--mesh", "data=4", "--blocks_to_swap", "4"]
    with pytest.raises(SystemExit) as ref:
        jcli.main(argv)
    ref_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as got:
        tcli.main(argv + ["--device", "cpu"])
    assert got.value.code == ref.value.code == 2
    assert "--blocks_to_swap is a single-chip memory mode; drop --mesh" in ref_err
    assert "--blocks_to_swap is a single-chip memory mode; drop --mesh" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--quantization", "int8"], ["--quantization", "int4"],
    ["--quantization", "fp8_e4m3fn", "--blocks_to_swap", "4"],
    ["--quantization", "int8_dynamic", "--blocks_to_swap", "5", "--prefetch_blocks", "1"]])
def test_memory_modes_match_jax(model_dir, monkeypatch, tmp_path, argv):
    """The memory-mode flags through the checkpoint route of both CLIs: the same
    quantization on both sides (the JAX CLI's block swap needs a ``pinned_host`` memory kind
    and runs unsplit here; the port's split forward is exact, ``test_torch_offload.py``)."""
    ref, got = _both(monkeypatch, tmp_path,
                     ["--model_path", str(model_dir), "--duration", "1"] + RUN + argv)
    assert got.shape == ref.shape == (48000,)
    assert np.abs(got - ref).max() <= PCM_TOL


def test_random_init_block_swap_is_exact(tmp_path):
    """``--blocks_to_swap`` with ``--prefetch_blocks`` on the random-init route (the card's
    ``cli`` phase): the same WAV as the resident model, int4 storage on both."""
    base = ["--random_init", "tiny", "--random_init_perturb", "--precision", "fp32",
            "--quantization", "int4", "--duration", "1", "--num_inference_steps", "2",
            "--device", "cpu"]
    assert tcli.main(base + ["--output", str(tmp_path / "resident.wav")]) == 0
    assert tcli.main(base + ["--blocks_to_swap", "5", "--prefetch_blocks", "1", "--output",
                             str(tmp_path / "swapped.wav")]) == 0
    np.testing.assert_array_equal(_read(tmp_path / "swapped.wav"),
                                  _read(tmp_path / "resident.wav"))


@pytest.mark.parametrize("argv", [
    ["--random_init", "tiny", "--prefetch_blocks", "1"],
    ["--random_init", "tiny", "--stream_pcm", "--audio_input", "x.wav"],
    ["--random_init", "tiny", "--stream_pcm", "--csv_path", "rows.csv"],
    ["--random_init", "tiny", "--stream_pcm", "--gradio"],
    ["--gradio"],
    ["--single_prompt", "x"]])
def test_argument_checks_match_jax(capsys, argv):
    """The JAX CLI's own argument checks (``cli.py:126-138`` and the model-source ones):
    the same exit code 2 and message."""
    rc_j = jcli.main(argv)
    err_j = capsys.readouterr().err.strip().splitlines()[-1]
    rc_t = tcli.main(argv + ["--device", "cpu"])
    err_t = capsys.readouterr().err.strip().splitlines()[-1]
    assert rc_j == rc_t == 2
    assert err_t == err_j


def test_first_window_needs_stream_pcm(capsys):
    """The JAX CLI's check after the model load (``tests/test_cli_stream.py`` holds its
    message): a ramp is for streams only."""
    assert tcli.main(["--random_init", "tiny", "--precision", "fp32", "--duration", "1",
                      "--first_window", "0.5", "--device", "cpu"]) == 2
    assert capsys.readouterr().err.strip().splitlines()[-1] == (
        "error: --first_window is a --stream_pcm latency ramp (batch outputs gain nothing "
        "from it)")


def test_read_wav_mono_matches_jax_and_refuses_other_formats(tmp_path):
    """48 kHz 16-bit input only; a stereo file mixes down to the JAX reader's samples."""
    stereo = _write_wav(tmp_path / "stereo.wav", seconds=0.1, channels=2, seed=3)
    np.testing.assert_array_equal(tcli._read_wav_mono(stereo), jcli._read_wav_mono(stereo))
    with pytest.raises(ValueError, match="48 kHz"):
        tcli._read_wav_mono(_write_wav(tmp_path / "low.wav", 0.1, rate=16000))
    with pytest.raises(ValueError, match="16-bit"):
        tcli._read_wav_mono(_write_wav(tmp_path / "s24.wav", 0.1, width=3))


def test_out_of_memory_hint_speaks_of_the_card(monkeypatch, capsys):
    """An out-of-memory error exits 1 with the card's hint, not the TPU's."""
    from foley_tpu_torch.api import nodes

    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setattr(nodes.HunyuanModelLoader, "init_random", staticmethod(oom))
    assert tcli.main(["--random_init", "tiny", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "card's memory" in err and "--precision bf16" in err and "16 GiB" not in err


def test_stream_writes_to_a_given_sink(monkeypatch):
    """``_stream_pcm``'s ``out``: the chunks' int16 bytes in order, nothing else."""
    chunks = [tlong.StreamChunk(0, None, np.arange(4, dtype=np.int16)[None], 48000, 0, 2,
                                False),
              tlong.StreamChunk(4, None, np.arange(4, 7, dtype=np.int16)[None], 48000, 1, 2,
                                True)]
    monkeypatch.setattr(tlong, "generate_audio_long_stream", lambda *a, **k: iter(chunks))
    monkeypatch.setattr(tcli, "_bundle_and_text", lambda args, fm, deps: (
        tgen.ModelBundle(None, None, TINY), None, None))
    args = tcli.build_parser().parse_args(["--stream_pcm", "--duration", "1"])
    sink = io.BytesIO()
    assert tcli._stream_pcm(args, {}, {}, out=sink) == 0
    assert np.frombuffer(sink.getvalue(), "<i2").tolist() == list(range(7))
