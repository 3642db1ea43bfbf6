"""Long-run training validation on the port (the counterpart of ``tools/train_longrun.py``,
with its arguments): the whole pipeline, WAV corpus -> DAC latent shards ->
``flow_match_batches`` -> ``PrefetchLoader`` -> the train step, over hundreds of steps, must
*learn*, not just run:

- the loss falls substantially (an overfit of a tiny fixed corpus: the tail's mean under
  0.7 of the head's);
- no NaN or Inf in the trajectory or the final parameters;
- mid-run ``.safetensors`` checkpoints (the JAX tool's orbax ones have no port) do not
  perturb training;
- the train -> deploy export loads through ``HunyuanModelLoader`` and generates finite
  audio in 8 steps.

The corpus is the JAX tool's: six synthesized clips (tones, a chirp, filtered noise, a
square wave, a random walk) from the same numpy seed, written as the same WAV bytes.

Run it with ``python -m foley_tpu_torch.tools.train_longrun [--num_steps 600] [--config
tiny]`` on a machine with a CUDA card, or ``--device cpu``. It prints one JSON line with the
JAX tool's keys (``loss_head``, ``loss_tail``, ``loss_drop_ratio``, ``finite``,
``deploy_ok``, ``ok``, ``trajectory``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from typing import Dict

import numpy as np
import torch

from foley_tpu_torch.core.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="tiny", choices=["tiny", "xl", "xxl"])
    ap.add_argument("--num_steps", type=int, default=600)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--clip_seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap


def synthesize_corpus(root: str, clip_seconds: float) -> int:
    """The JAX tool's fixed six-clip corpus under ``root`` (``clip_<i>.wav``, 48 kHz);
    returns the number of clips."""
    from foley_tpu_torch.io.audio import write_wav

    os.makedirs(root)
    rng = np.random.default_rng(0)
    n = int(48000 * clip_seconds)
    t = np.linspace(0, clip_seconds, n, False)
    clips = [
        0.3 * np.sin(2 * np.pi * 220 * t) * np.exp(-2 * t),
        0.3 * np.sin(2 * np.pi * 440 * t) * np.exp(-1 * t),
        0.3 * np.sin(2 * np.pi * (200 + 800 * t) * t),
        0.2 * rng.standard_normal(n) * np.exp(-4 * t),
        0.25 * np.sign(np.sin(2 * np.pi * 110 * t)) * np.exp(-3 * t),
        0.2 * np.cumsum(rng.standard_normal(n)) / np.sqrt(np.arange(1, n + 1)),
    ]
    for i, wav in enumerate(clips):
        write_wav(os.path.join(root, f"clip_{i}.wav"), wav.astype(np.float32), 48000)
    return len(clips)


def run(args: argparse.Namespace) -> Dict:
    """The validation on ``args.device`` -> the JSON record; its working files (the corpus,
    the shards, the checkpoints, the export) in a temporary directory, removed after."""
    from foley_tpu_torch.configs import get_config

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    workdir = tempfile.mkdtemp(prefix="foley_longrun_")
    try:
        return _run(args, dev, cfg, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(args: argparse.Namespace, dev: torch.device, cfg, workdir: str) -> Dict:
    """``run`` in ``workdir``: the corpus, the shards, the training, the deploy."""
    from foley_tpu_torch.api.nodes import HunyuanModelLoader
    from foley_tpu_torch.models import dac_vae, mmdit
    from foley_tpu_torch.pipeline.generate import ModelBundle, generate_audio
    from foley_tpu_torch.training import loop
    from foley_tpu_torch.training.data import (
        AudioFolderDataset,
        NpzShardDataset,
        PrefetchLoader,
        encode_corpus,
        flow_match_batches,
        latent_stats_from_shards,
    )

    corpus = os.path.join(workdir, "wavs")
    n_clips = synthesize_corpus(corpus, args.clip_seconds)

    dac = dac_vae.init(cfg.dac, torch.Generator(device=dev).manual_seed(0), device=dev)
    shard_dir = os.path.join(workdir, "shards")
    dataset = AudioFolderDataset(corpus, args.clip_seconds, cfg.dac.sample_rate, seed=0)
    encode_corpus(dac, dataset, shard_dir, num_clips=n_clips * 4, batch_size=args.batch_size)

    model = mmdit.init(cfg.model, torch.Generator(device=dev).manual_seed(1), device=dev)
    # from-scratch training: standardize latents to the unit-noise scale (the random-init
    # DAC encoder's raw latents are arbitrarily scaled; a pretrained run would pass None)
    stats = latent_stats_from_shards(shard_dir)
    batches = PrefetchLoader(
        flow_match_batches(iter(NpzShardDataset(shard_dir)), model, cfg,
                           batch_size=args.batch_size, latent_stats=stats),
        depth=2, device=dev)
    losses = []
    try:
        state = loop.train(model, iter(batches), num_steps=args.num_steps,
                           ckpt_dir=os.path.join(workdir, "ckpts"),
                           ckpt_every=max(args.num_steps // 3, 1), log_every=10,
                           metrics_fn=lambda step, loss: losses.append((step, loss)))
    finally:
        batches.close()

    vals = np.array([v for _, v in losses])
    k = max(len(vals) // 10, 1)
    head, tail = float(vals[:k].mean()), float(vals[-k:].mean())
    finite = bool(np.all(np.isfinite(vals))) and all(
        bool(torch.isfinite(p).all()) for p in state.params.values())

    # train -> deploy: the exported parameters generate finite audio through the sampler
    export_dir = os.path.join(workdir, "deploy")
    loop.export_for_inference(state, export_dir, latent_stats=stats)
    (fm,) = HunyuanModelLoader().load_model(export_dir, precision="fp32", config=args.config,
                                            device=dev)
    bundle = ModelBundle(fm["params"], dac, cfg, compute_dtype=torch.float32,
                         latent_stats=fm.get("latent_stats"))
    text = torch.zeros((1, 8, cfg.model.condition_dim), dtype=torch.float32, device=dev)
    res = generate_audio(bundle, text, text, args.clip_seconds, num_inference_steps=8,
                         batch_size=1, seed=0)
    deploy_ok = bool(np.isfinite(np.asarray(res.audio_batch)).all())

    return {
        "tool": "train_longrun",
        "config": args.config,
        "num_steps": args.num_steps,
        "loss_head": round(head, 5),
        "loss_tail": round(tail, 5),
        "loss_drop_ratio": round(head / max(tail, 1e-9), 3),
        "finite": finite,
        "deploy_ok": deploy_ok,
        "ok": bool(finite and deploy_ok and tail < 0.7 * head),
        "trajectory": [(int(s), round(float(v), 5))
                       for s, v in losses[::max(len(losses) // 20, 1)]],
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(json.dumps(run(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
