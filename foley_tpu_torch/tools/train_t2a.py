"""End-to-end T2A fine-tuning on the port: WAV corpus -> DAC latent shards -> flow-matching
steps (the counterpart of ``examples/train_t2a.py``, with its arguments).

Runnable with no checkpoints (a random model and a synthesized corpus of four tones); point
``--corpus`` / ``--model_path`` at real data and a reference checkpoint for real
fine-tuning. The recipe:

1. ``AudioFolderDataset`` crops fixed-length clips from a WAV folder;
2. ``encode_corpus`` DAC-encodes them once into ``.npz`` latent shards;
3. ``flow_match_batches`` assembles ``{latents, cond, clip_feat, sync_feat}`` with the
   model's learned empty sequences (audio-only conditioning, the T2A branch);
4. ``PrefetchLoader`` stages the batches on the device from a thread;
5. ``training.loop.train`` runs the flow-matching steps with ``.safetensors`` checkpoints
   and exact resume; ``--export_dir`` then writes what ``HunyuanModelLoader`` loads.

Run it with ``python -m foley_tpu_torch.tools.train_t2a`` on a machine with a CUDA card; a
caller may pass ``main(argv, device="cpu")`` to run it on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import tempfile

import numpy as np
import torch

from foley_tpu_torch.core.device import DeviceLike, resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", default="", help="folder of WAV files (synthesized if empty)")
    ap.add_argument("--config", default="tiny", choices=["tiny", "xl", "xxl"])
    ap.add_argument("--clip_seconds", type=float, default=1.0)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--num_steps", type=int, default=10)
    ap.add_argument("--num_clips", type=int, default=8, help="clips to encode into shards")
    ap.add_argument("--ckpt_dir", default="",
                    help=".safetensors checkpoint dir (resume-exact)")
    ap.add_argument("--model_path", default="",
                    help="pretrained MMDiT to fine-tune (.pth/.safetensors, or a directory "
                         "export_for_inference wrote); random init if empty")
    ap.add_argument("--dac_path", default="",
                    help="DAC-VAE checkpoint used to encode the corpus; REQUIRED with "
                         "--model_path (a pretrained MMDiT only understands latents from "
                         "the DAC it was trained with — encoding with a random DAC would "
                         "silently destroy it)")
    ap.add_argument("--export_dir", default="",
                    help="after training, export bare params (+ latent stats when training "
                         "from scratch) in the layout HunyuanModelLoader loads")
    return ap


def _synthesize_corpus(root: str, clip_seconds: float) -> None:
    """Four decaying tones, 220-550 Hz, ``clip_seconds`` long, 48 kHz."""
    from foley_tpu_torch.io.audio import write_wav

    os.makedirs(root)
    for i in range(4):
        t = np.linspace(0, clip_seconds, int(48000 * clip_seconds), False)
        wav = 0.3 * np.sin(2 * np.pi * (220 + 110 * i) * t) * np.exp(-2 * t)
        write_wav(os.path.join(root, f"tone_{i}.wav"), wav.astype(np.float32), 48000)


def main(argv=None, device: DeviceLike = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.model_path and not args.dac_path:
        ap.error("--model_path fine-tuning requires --dac_path (see its help)")
    logging.basicConfig(level=logging.INFO, stream=sys.stderr, format="%(asctime)s %(message)s")

    from foley_tpu_torch.configs import get_config
    from foley_tpu_torch.models import dac_vae, mmdit
    from foley_tpu_torch.training.data import (
        AudioFolderDataset,
        NpzShardDataset,
        PrefetchLoader,
        encode_corpus,
        flow_match_batches,
        latent_stats_from_shards,
    )
    from foley_tpu_torch.training.loop import export_for_inference, train

    dev = resolve_device(device)
    cfg = get_config(args.config)
    workdir = tempfile.mkdtemp(prefix="foley_train_")

    corpus = args.corpus
    if not corpus:  # a toy corpus, so the tool runs anywhere
        corpus = os.path.join(workdir, "wavs")
        _synthesize_corpus(corpus, args.clip_seconds)
        print(f"synthesized 4 demo clips under {corpus}")

    if args.dac_path:
        from foley_tpu_torch.io.convert import (
            convert_dac_state_dict,
            load_torch_state_dict,
            module_from_state_dict,
        )

        dac = module_from_state_dict(
            dac_vae.DAC, convert_dac_state_dict(load_torch_state_dict(args.dac_path), cfg.dac,
                                                consume=True), cfg.dac, dev, torch.float32)
    else:
        dac = dac_vae.init(cfg.dac, torch.Generator(device=dev).manual_seed(0), device=dev)
    shard_dir = os.path.join(workdir, "shards")
    dataset = AudioFolderDataset(corpus, args.clip_seconds, cfg.dac.sample_rate, seed=0)
    encode_corpus(dac, dataset, shard_dir, num_clips=args.num_clips,
                  batch_size=args.batch_size)
    del dac

    if args.model_path:
        from foley_tpu_torch.api.nodes import HunyuanModelLoader

        (fm,) = HunyuanModelLoader().load_model(args.model_path, precision="fp32",
                                                config=args.config, device=dev)
        model = fm["params"]
    else:
        model = mmdit.init(cfg.model, torch.Generator(device=dev).manual_seed(1), device=dev)
    # standardize the latents when training from scratch (a random DAC's latents have an
    # arbitrary scale); a pretrained model lives in the raw DAC latent space
    stats = latent_stats_from_shards(shard_dir) if not args.model_path else None
    batches = PrefetchLoader(
        flow_match_batches(iter(NpzShardDataset(shard_dir)), model, cfg,
                           batch_size=args.batch_size, latent_stats=stats),
        depth=2, device=dev)
    try:
        state = train(model, iter(batches), num_steps=args.num_steps,
                      ckpt_dir=args.ckpt_dir or None, log_every=max(args.num_steps // 5, 1))
    finally:
        batches.close()
    if args.export_dir:
        export_for_inference(state, args.export_dir, latent_stats=stats)
    print(f"done: {state.step} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
