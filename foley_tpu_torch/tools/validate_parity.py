"""Parity gate on the port (the counterpart of ``tools/validate_parity.py``, with its
arguments): score generated audio against reference outputs.

Usage: ``python -m foley_tpu_torch.tools.validate_parity ours.wav reference.wav [--threshold
0.99]``

Computes the BASELINE.json criterion (magnitude-STFT spectral correlation >= threshold) and
the SNR with ``utils/metrics.py``; exit code 0 iff the gate passes, 1 if it fails, 2 on a
sample-rate mismatch. ``--self_test`` proves the gate without checkpoints: two same-seed
tiny generations through the port's CLI must score 1.0 and pass, a different-seed pair
must fail. The generations run on ``--device`` (cuda unless given).
"""

from __future__ import annotations

import argparse
import os
import sys
import wave

import numpy as np


def read_wav(path: str) -> tuple:
    """A 16-bit PCM WAV -> (mono float32 / 32767, sample rate), the JAX tool's reading."""
    with wave.open(path) as f:
        sr = f.getframerate()
        pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        pcm = pcm.reshape(-1, f.getnchannels()).mean(axis=1)
    return pcm.astype(np.float32) / 32767.0, sr


def self_test(device: str = "cuda") -> int:
    """Two same-seed tiny generations must score corr=1.0 / PASS, and a different-seed pair
    must score well below the threshold / FAIL."""
    import tempfile

    from foley_tpu_torch.cli import main as cli_main

    with tempfile.TemporaryDirectory(prefix="parity_selftest_") as tmp:
        paths = [os.path.join(tmp, n) for n in ("a.wav", "b.wav", "c.wav")]
        for path, seed in zip(paths, (7, 7, 8)):
            rc = cli_main(["--random_init", "tiny", "--single_prompt", "x", "--duration",
                           "1", "--num_inference_steps", "4", "--precision", "fp32",
                           "--seed", str(seed), "--device", device, "--output", path])
            if rc != 0:
                raise RuntimeError(f"generation failed for {path}")
        same = main([paths[0], paths[1]])
        diff = main([paths[0], paths[2]])
    ok = same == 0 and diff == 1
    print(f"self_test: same-seed {'PASS' if same == 0 else 'FAIL'}, "
          f"diff-seed {'correctly rejected' if diff == 1 else 'WRONGLY PASSED'} "
          f"-> {'OK' if ok else 'BROKEN'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ours", nargs="?")
    p.add_argument("reference", nargs="?")
    p.add_argument("--threshold", type=float, default=0.99)
    p.add_argument("--self_test", action="store_true",
                   help="prove the gate end-to-end with checkpoint-free tiny generations")
    p.add_argument("--device", default="cuda", help="--self_test's device (default cuda)")
    args = p.parse_args(argv)
    if args.self_test:
        return self_test(args.device)
    if not args.ours or not args.reference:
        p.error("ours and reference WAV paths are required (or pass --self_test)")

    from foley_tpu_torch.utils.metrics import snr_db, spectral_correlation

    ours, sr_a = read_wav(args.ours)
    ref, sr_b = read_wav(args.reference)
    if sr_a != sr_b:
        print(f"sample-rate mismatch: {sr_a} vs {sr_b}", file=sys.stderr)
        return 2
    corr = spectral_correlation(ours, ref)
    snr = snr_db(ours, ref)
    ok = corr >= args.threshold
    print(f"spectral_correlation={corr:.5f} (threshold {args.threshold}) snr_db={snr:.2f} "
          f"-> {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
