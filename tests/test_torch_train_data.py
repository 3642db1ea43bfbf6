"""The port's training data pipeline (``training/data.py``) against the JAX package's
``foley_tpu/training/data.py``, on the CPU: the counterparts of
``tests/test_training_data.py``.

The datasets draw from numpy generators as the JAX package does, so the crops, the shard
order and the CFG drop masks are equal bit for bit; the shards are the same ``.npz`` format,
and each package reads the other's. ``encode_corpus``'s latents are held with the posterior
noise left out on both sides (``jax.random`` and a ``torch.Generator`` draw other bits):
the DAC's mean, within ``tests/test_torch_dac.py``'s tolerance.
"""

import os

import jax
import numpy as np
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.io.audio import write_wav
from foley_tpu.models import dac_vae as jdac
from foley_tpu.models import mmdit as jmm
from foley_tpu.training import data as jdata
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.io.from_jax import mmdit_from_jax
from foley_tpu_torch.models import dac_vae as tdac
from foley_tpu_torch.models import mmdit as tmm
from foley_tpu_torch.training import data as tdata
from test_torch_dac import TOL as DAC_TOL
from test_torch_dac import models as dac_models  # noqa: F401 (a fixture)
from test_torch_mmdit import seeded_tree
from torch_helpers import jax_tree_from_port, one_torch_thread  # noqa: F401 (autouse)
from torch_helpers import jax_native_library  # noqa: F401 (autouse)


def _write_corpus(root, n=3, seconds=0.2, sr=48000, seed=1):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):  # different lengths, one at another rate
        rate = sr if i else 24000
        wav = (rng.standard_normal(int(rate * seconds * (i + 1))) * 0.3).astype(np.float32)
        write_wav(os.path.join(root, f"clip_{i}.wav"), wav, rate)


def test_audio_folder_crops_equal_jax(tmp_path):
    """Short files looped, long ones cropped at the same draws, one file resampled: the same
    items in the same order, bit for bit; ``batch_items`` stacks them alike."""
    _write_corpus(str(tmp_path), n=3, seconds=0.2)
    assert tdata.list_audio_files(str(tmp_path)) == jdata.list_audio_files(str(tmp_path))
    got_it = iter(tdata.AudioFolderDataset(str(tmp_path), 0.3, 48000, seed=4))
    ref_it = iter(jdata.AudioFolderDataset(str(tmp_path), 0.3, 48000, seed=4))
    got, ref = [next(got_it) for _ in range(7)], [next(ref_it) for _ in range(7)]
    for g, r in zip(got, ref):
        assert g["path"] == r["path"] and g["audio"].shape == (14400,)
        np.testing.assert_array_equal(g["audio"], r["audio"])
    (gb,), (rb,) = (list(mod.batch_items(iter(items), 7, keys=("audio",)))
                    for mod, items in ((tdata, got), (jdata, ref)))
    np.testing.assert_array_equal(gb["audio"], rb["audio"])
    with pytest.raises(FileNotFoundError):
        tdata.AudioFolderDataset(str(tmp_path / "empty"), 0.3)


def test_encode_corpus_matches_jax_and_shards_cross_read(tmp_path, dac_models, monkeypatch):
    """``encode_corpus`` with the posterior's mean: the same shards (names, rows, paths) with
    latents within the DAC tests' tolerance; each package's ``NpzShardDataset`` reads the
    other's shards into the same stream; ``latent_stats_from_shards`` equal."""
    params, dac = dac_models
    monkeypatch.setattr(jdac.GaussianPosterior, "sample", lambda self, key: self.mean)
    monkeypatch.setattr(tdac.GaussianPosterior, "sample", lambda self, generator=None: self.mean)
    corpus = str(tmp_path / "wavs")
    _write_corpus(corpus, n=2, seconds=0.1)
    hop_s = J_TINY.dac.hop_length / J_TINY.dac.sample_rate
    clip_s = 6 * hop_s  # six latent frames
    shards = {}
    for name, mod, model in (("jax", jdata, params), ("port", tdata, dac)):
        ds = mod.AudioFolderDataset(corpus, clip_s, J_TINY.dac.sample_rate, seed=0)
        args = (model, J_TINY.dac) if name == "jax" else (model,)
        shards[name] = mod.encode_corpus(*args, ds, str(tmp_path / name), num_clips=5,
                                         batch_size=2, shard_size=3)
    assert [os.path.basename(p) for p in shards["port"]] == [
        os.path.basename(p) for p in shards["jax"]] == ["shard_00000.npz", "shard_00001.npz"]
    for g, r in zip(shards["port"], shards["jax"]):
        with np.load(g) as zg, np.load(r) as zr:
            assert sorted(zg.files) == sorted(zr.files) == ["latents", "paths"]
            np.testing.assert_array_equal(zg["paths"], zr["paths"])
            assert zg["latents"].shape == zr["latents"].shape == (4 if "00000" in g else 1, 6,
                                                                   J_TINY.dac.latent_dim)
            np.testing.assert_allclose(zg["latents"], zr["latents"], **DAC_TOL)
    for reader, writer in ((tdata, "jax"), (jdata, "port")):
        own = iter(({"jax": jdata, "port": tdata}[writer]).NpzShardDataset(
            str(tmp_path / writer), seed=3))
        other = iter(reader.NpzShardDataset(str(tmp_path / writer), seed=3))
        for _ in range(8):
            a, b = next(own), next(other)
            assert sorted(a) == sorted(b) == ["latents"]
            np.testing.assert_array_equal(a["latents"], b["latents"])
    for got, ref in zip(tdata.latent_stats_from_shards(str(tmp_path / "jax")),
                        jdata.latent_stats_from_shards(str(tmp_path / "jax"))):
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def denoisers():
    params = seeded_tree(jax_tree_from_port(
        tmm.init(TINY.model, torch.Generator().manual_seed(0), device="cpu"), jmm.init,
        J_TINY.model), seed=3)
    return params, mmdit_from_jax(params, TINY.model, device="cpu")


def _av_shards(root, n=5, lat=10, seed=2):
    """Shards as ``encode_av_corpus`` writes them (latents, clip and sync features, paths)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    cfg = TINY.model
    for s, rows in enumerate((3, n - 3)):
        np.savez(os.path.join(root, f"shard_{s:05d}.npz"), paths=np.asarray(["x"] * rows),
                 latents=rng.normal(size=(rows, lat, cfg.audio_vae_latent_dim)).astype(np.float32),
                 clip_feat=rng.normal(size=(rows, 4, cfg.clip_dim)).astype(np.float32),
                 sync_feat=rng.normal(size=(rows, 16, cfg.sync_feat_dim)).astype(np.float32))


@pytest.mark.parametrize("visual", [False, True], ids=["t2a", "av"])
def test_flow_match_batches_equal_jax(tmp_path, denoisers, visual):
    """The batches of audio-only shards (the learned empty sequences at the T2A lengths,
    standardized latents) and of AV shards with CFG visual dropout at p = 0.5 (the drop
    masks drawn alike): equal bit for bit."""
    params, model = denoisers
    root = str(tmp_path)
    if visual:
        _av_shards(root)
        kw = dict(drop_visual_p=0.5)
    else:
        rng = np.random.default_rng(5)
        np.savez(os.path.join(root, "shard_00000.npz"), paths=np.asarray(["a"] * 4),
                 latents=rng.normal(size=(4, TINY.latent_length(1.0), 8)).astype(np.float32))
        kw = dict(latent_stats=(np.full(8, 0.5, np.float32), np.full(8, 2.0, np.float32)))
    streams = [mod.flow_match_batches(iter(mod.NpzShardDataset(root, seed=1)), tree, cfg,
                                      batch_size=2, text_bucket=8,
                                      drop_rng=np.random.default_rng(7), **kw)
               for mod, tree, cfg in ((tdata, model, TINY), (jdata, params, J_TINY))]
    drops = 0
    for _ in range(4):
        got, ref = (next(s) for s in streams)
        assert sorted(got) == sorted(ref) == ["clip_feat", "cond", "latents", "sync_feat"]
        for k in got:
            assert got[k].dtype == np.float32, k
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        empty = np.asarray(jmm.get_empty_clip_sequence(params, 2, got["clip_feat"].shape[1]))
        drops += int(sum(np.array_equal(got["clip_feat"][i], empty[i]) for i in range(2)))
    assert drops > 0 if visual else drops == 8


def test_prefetch_loader_keeps_order_and_raises(tmp_path):
    src = [{"x": np.full((2, 3), float(i), np.float32)} for i in range(5)]
    out = list(tdata.PrefetchLoader(iter(src), depth=2, device="cpu"))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), src[i]["x"])

    def bad():
        yield {"x": np.zeros(2, np.float32)}
        raise ValueError("loader boom")

    it = tdata.PrefetchLoader(bad(), depth=1, device="cpu")
    next(it)
    with pytest.raises(ValueError, match="loader boom"):
        next(it)
    loader = tdata.PrefetchLoader(iter(src * 100), depth=1, device="cpu")
    next(loader)
    loader.close()
    loader._thread.join(timeout=5)
    assert not loader._thread.is_alive()


def _write_av_corpus(root, rng, n_clips=2, seconds=1.0, fps=16, size=40, sr=48000):
    """Per-clip PNG frames directory and WAV: clip_0 with a sibling WAV, clip_1 with it
    inside (the JAX test's corpus)."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    for c in range(n_clips):
        d = os.path.join(root, f"clip_{c}")
        os.makedirs(d, exist_ok=True)
        for f in range(int(seconds * fps)):
            Image.fromarray((rng.random((size, size, 3)) * 255).astype(np.uint8)).save(
                os.path.join(d, f"f_{f:04d}.png"))
        wav = (rng.standard_normal(int(sr * seconds)) * 0.3).astype(np.float32)
        write_wav(os.path.join(d, "audio.wav") if c % 2 else d + ".wav", wav, sr)


def test_av_corpus_crops_equal_jax_and_encode(tmp_path, denoisers):
    """``list_av_clips`` and ``AVFolderDataset``'s synced crops equal JAX's bit for bit (PNG
    frames decoded without PIL); ``encode_av_corpus`` through the port's sampler-node encode
    writes shards that ``flow_match_batches`` turns into V2A batches, dropout included."""
    from foley_tpu_torch.models import siglip2, synchformer

    corpus = str(tmp_path / "av")
    _write_av_corpus(corpus, np.random.default_rng(4))
    assert tdata.list_av_clips(corpus) == jdata.list_av_clips(corpus)
    assert len(tdata.list_av_clips(corpus)) == 2
    got_it = iter(tdata.AVFolderDataset(corpus, 0.5, 48000, frames_fps=16, seed=0,
                                        device="cpu"))
    ref_it = iter(jdata.AVFolderDataset(corpus, 0.5, 48000, frames_fps=16, seed=0))
    for _ in range(3):
        g, r = next(got_it), next(ref_it)
        assert g["frames"].shape == (8, 40, 40, 3) and g["vfps"] == r["vfps"] == 16.0
        np.testing.assert_array_equal(g["audio"], r["audio"])
        np.testing.assert_array_equal(g["frames"], r["frames"])

    _, model = denoisers
    dim = TINY.model.clip_dim
    encoders = {"siglip2": siglip2.init_random(0, dim, device="cpu"),
                "synchformer": synchformer.init_random(1, TINY.model.sync_feat_dim,
                                                       device="cpu")}
    dac = tdac.init(TINY.dac, torch.Generator().manual_seed(0), device="cpu")
    ds = tdata.AVFolderDataset(corpus, 0.5, TINY.dac.sample_rate, frames_fps=16, seed=0,
                               device="cpu")
    shard_dir = str(tmp_path / "shards")
    shards = tdata.encode_av_corpus(dac, encoders, TINY, ds, shard_dir, num_clips=3,
                                    clip_seconds=0.5, shard_size=2)
    assert len(shards) == 2
    probe = next(iter(tdata.NpzShardDataset(shard_dir, seed=0)))
    assert sorted(probe) == ["clip_feat", "latents", "sync_feat"]
    assert probe["latents"].shape == (TINY.latent_length(0.5), TINY.dac.latent_dim)
    assert probe["clip_feat"].shape == (4, dim) and np.isfinite(probe["sync_feat"]).all()
    batch = next(tdata.flow_match_batches(iter(tdata.NpzShardDataset(shard_dir, seed=0)), model,
                                          TINY, batch_size=2, text_bucket=8, drop_visual_p=1.0,
                                          drop_rng=np.random.default_rng(0)))
    empty = tmm.get_empty_clip_sequence(model, 2, 4).detach().numpy()
    np.testing.assert_array_equal(batch["clip_feat"], empty)
