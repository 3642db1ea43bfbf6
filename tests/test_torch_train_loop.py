"""The port's training loops (``training/loop.py``), their checkpoints and the train -> deploy
handoff, and ``tools/train_t2a.py``, on the CPU at TINY: the counterparts of
``tests/test_parallel.py::test_training_loop_checkpoint_resume`` and
``tests/test_lora.py::test_train_lora_loop_resume_and_export``.

A run interrupted at step 2 and resumed from its ``.safetensors`` checkpoint equals the
uninterrupted run bit for bit (the same data stream from step 2; per-step generators from
(seed, step)); an export loads through ``HunyuanModelLoader`` (a directory, or an adapter as
``lora_path``) and serves.
"""

import os

import numpy as np
import pytest
import torch

from foley_tpu_torch.api.nodes import HunyuanModelLoader
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.core.params import perturb_zero_leaves
from foley_tpu_torch.io.convert import load_safetensors
from foley_tpu_torch.models import dac_vae, lora as tlora, mmdit as tmm
from foley_tpu_torch.pipeline.generate import ModelBundle, generate_audio
from foley_tpu_torch.training import loop
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

CFG = TINY.model
B, T = 2, 10


def _model(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return perturb_zero_leaves(tmm.init(CFG, gen, device="cpu"), gen)


def _batches(skip=0):
    """A fixed stream of numpy batches (seed 42), its first ``skip`` consumed."""
    rng = np.random.default_rng(42)
    shapes = {"latents": (B, T, CFG.audio_vae_latent_dim), "cond": (B, 6, CFG.condition_dim),
              "clip_feat": (B, 4, CFG.clip_dim), "sync_feat": (B, 8, CFG.sync_feat_dim)}
    i = 0
    while True:
        batch = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        if i >= skip:
            yield batch
        i += 1


def _assert_states_equal(a, b, leaves_a, leaves_b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for name, t in leaves_a.items():
        assert torch.equal(t, leaves_b[name]), name
        assert torch.equal(a.opt_state.mu[name], b.opt_state.mu[name]), name
        assert torch.equal(a.opt_state.nu[name], b.opt_state.nu[name]), name


def test_train_resume_is_exact(tmp_path):
    straight = loop.train(_model(), _batches(), num_steps=4, log_every=0, seed=7)
    ck = str(tmp_path / "ck")
    loop.train(_model(), _batches(), num_steps=2, ckpt_dir=ck, ckpt_every=10, log_every=0,
               seed=7)
    latest = loop.latest_checkpoint(ck)
    assert latest == os.path.join(ck, "step_00000002")
    assert os.listdir(latest) == [loop.STATE_FILE]  # one .safetensors file, nothing else
    saved = load_safetensors(os.path.join(latest, loop.STATE_FILE))
    names = [k for k, _ in _model().named_parameters()]
    assert set(saved) == ({f"{p}.{k}" for p in ("params", "mu", "nu") for k in names}
                          | {"step", "count"})
    assert int(saved["step"]) == 2
    resumed = loop.train(_model(), _batches(skip=2), num_steps=4, ckpt_dir=ck, log_every=0,
                         seed=7)
    _assert_states_equal(straight, resumed, straight.params, resumed.params)
    assert loop.latest_checkpoint(ck).endswith("step_00000004")
    other_seed = loop.train(_model(), _batches(), num_steps=4, log_every=0, seed=8)
    assert not torch.equal(other_seed.opt_state.mu["final_layer.linear.weight"],
                           straight.opt_state.mu["final_layer.linear.weight"])  # other draws


def test_restore_refuses_another_state(tmp_path):
    """A checkpoint restores only into a state of the same names, shapes and dtypes."""
    model = _model()
    state = loop.train(model, _batches(), num_steps=1, ckpt_dir=str(tmp_path), log_every=0)
    lora = tlora.init_lora(model, torch.Generator().manual_seed(1), rank=2)
    init_lora_state, _ = loop.make_lora_train_step(model)
    with pytest.raises(ValueError, match="differ from the state's"):
        loop.restore_checkpoint(loop.latest_checkpoint(str(tmp_path)), init_lora_state(lora))
    assert loop.restore_checkpoint(loop.latest_checkpoint(str(tmp_path)), state).step == 1


def test_train_lora_resume_export_and_loader(tmp_path):
    """LoRA: resume exact; ``export_lora`` then ``load_lora`` gives the factors back; the
    loader merges the adapter over an exported base (``lora_path``) into what the runtime
    adapter computes."""
    model = _model()
    lora0 = tlora.init_lora(model, torch.Generator().manual_seed(10), rank=4)
    straight = loop.train_lora(model, lora0, _batches(), num_steps=4, log_every=0)
    ck = str(tmp_path / "ck")
    loop.train_lora(model, lora0, _batches(), num_steps=2, ckpt_dir=ck, ckpt_every=2,
                    log_every=0)
    saved = load_safetensors(os.path.join(loop.latest_checkpoint(ck), loop.STATE_FILE))
    assert set(saved) == ({f"{p}.{k}" for p in ("lora", "mu", "nu") for k in lora0}
                          | {"step", "count"})  # the frozen base is not in it
    resumed = loop.train_lora(model, lora0, _batches(skip=2), num_steps=4, ckpt_dir=ck,
                              log_every=0)
    _assert_states_equal(straight, resumed, straight.lora, resumed.lora)

    adapter_dir = str(tmp_path / "adapter")
    loop.export_lora(resumed, adapter_dir, rank=4, scale=0.5)
    loaded, scale = tlora.load_lora(adapter_dir)
    assert scale == 0.5 and sorted(loaded) == sorted(resumed.lora)
    for k, v in resumed.lora.items():
        assert torch.equal(loaded[k], v.detach()), k

    base_dir = str(tmp_path / "base")
    base_state = loop.make_train_step(model)[0](model)
    loop.export_for_inference(base_state, base_dir)
    (fm,) = HunyuanModelLoader().load_model(base_dir, precision="fp32", config="tiny",
                                            lora_path=adapter_dir, lora_scale=2.0,
                                            device="cpu")
    assert "latent_stats" not in fm
    args = [torch.from_numpy(a) for a in next(_batches()).values()]
    x = args[0]
    with torch.no_grad():
        runtime = model(x, torch.tensor([300.0, 600.0]), *args[1:], lora=resumed.lora,
                        lora_scale=1.0)
        merged = fm["params"](x, torch.tensor([300.0, 600.0]), *args[1:])
    torch.testing.assert_close(merged, runtime, atol=1e-5, rtol=1e-5)


def test_export_for_inference_serves(tmp_path):
    """The bare state dict and ``latent_stats.npz``: the loader's directory route restores
    the trained weights and the stats exactly, and the model generates finite audio."""
    model = _model()
    state = loop.train(model, _batches(), num_steps=1, log_every=0)
    stats = (np.linspace(-1, 1, CFG.audio_vae_latent_dim).astype(np.float32),
             np.linspace(0.5, 2, CFG.audio_vae_latent_dim).astype(np.float32))
    out = str(tmp_path / "export")
    loop.export_for_inference(state, out, latent_stats=stats)
    assert sorted(os.listdir(out)) == [loop.LATENT_STATS_FILE, loop.EXPORT_FILE]
    (fm,) = HunyuanModelLoader().load_model(out, config="tiny", device="cpu")
    assert fm["dtype"] == torch.float32
    for k, v in fm["params"].state_dict().items():
        assert torch.equal(v, state.params[k]), k
    for got, want in zip(fm["latent_stats"], stats):
        np.testing.assert_array_equal(got.numpy(), want)
    dac = dac_vae.init(TINY.dac, torch.Generator().manual_seed(1), device="cpu")
    bundle = ModelBundle(fm["params"], dac, TINY, compute_dtype=torch.float32,
                         latent_stats=fm["latent_stats"])
    text = torch.zeros(1, 8, CFG.condition_dim)
    res = generate_audio(bundle, text, text, 1.0, num_inference_steps=2, seed=0,
                         fetch_pcm16=False)
    assert res.audio_batch.shape == (1, 1, 48000) and np.isfinite(res.audio_batch).all()
    assert np.abs(res.audio_batch).max() > 0


def test_train_t2a_tool_runs_at_tiny(tmp_path, monkeypatch, capsys):
    """``tools/train_t2a.py`` at its default config (TINY) on the CPU: a synthesized corpus,
    shards, prefetched batches, checkpoints, an export the loader serves."""
    import tempfile

    from foley_tpu_torch.tools import train_t2a

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ck, ex = str(tmp_path / "ck"), str(tmp_path / "export")
    assert train_t2a.main(["--clip_seconds", "0.5", "--num_clips", "4", "--num_steps", "3",
                           "--ckpt_dir", ck, "--export_dir", ex], device="cpu") == 0
    assert capsys.readouterr().out.strip().endswith("done: 3 steps")
    assert loop.latest_checkpoint(ck).endswith("step_00000003")
    (fm,) = HunyuanModelLoader().load_model(ex, config="tiny", device="cpu")
    assert len(fm["latent_stats"]) == 2  # trained from scratch: standardized latents
    with pytest.raises(SystemExit):  # fine-tuning a checkpoint needs the DAC it was trained with
        train_t2a.main(["--model_path", ex], device="cpu")
