"""Codec artifacts and chunked compress / decompress (``foley_tpu/models/dac_codec.py``
counterpart, the reference's ``CodecMixin`` / ``DACFile`` capability).

Audio is cut into fixed-size, hop-aligned chunks (the last one zero-padded), batched through
the encoder, and stored as the posterior means; an artifact from the discrete branch holds
RVQ codes instead. The ``.npz`` file holds the same arrays under the same names as the JAX
package's, so each package reads the other's files.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from foley_tpu_torch.models import dac_vae, quantize
from foley_tpu_torch.models.dac_vae import DAC
from foley_tpu_torch.models.quantize import RVQ


@dataclasses.dataclass
class DACFile:
    """An artifact in memory (reference ``base.py`` ``DACFile``)."""

    payload: np.ndarray          # latents [n_chunks, T_lat, D] or codes [n_chunks, N, T_lat]
    is_codes: bool
    sample_rate: int
    original_length: int         # samples
    chunk_samples: int

    def save(self, path: str) -> str:
        """Write ``path`` (``np.savez``, which appends ``.npz`` when it is missing)."""
        np.savez(path, payload=self.payload, is_codes=self.is_codes,
                 sample_rate=self.sample_rate, original_length=self.original_length,
                 chunk_samples=self.chunk_samples)
        return path

    @classmethod
    def load(cls, path: str) -> "DACFile":
        with np.load(path) as z:
            return cls(payload=z["payload"], is_codes=bool(z["is_codes"]),
                       sample_rate=int(z["sample_rate"]),
                       original_length=int(z["original_length"]),
                       chunk_samples=int(z["chunk_samples"]))


def codec_delay(cfg) -> int:
    """The encode -> decode round trip's latency in samples: 0. Every conv pads to the same
    length and the transposed convs invert the strides exactly, so chunks stay hop-aligned
    (the reference computes a per-layer receptive-field delay, ``base.py:18-120``)."""
    return 0


def compress(model: DAC, audio: np.ndarray, win_duration_s: float = 5.0) -> DACFile:
    """audio [T] or [T, 1] float -> the chunked latent artifact (each chunk's posterior
    mean), encoded on the model's device."""
    cfg = model.cfg
    wav = np.asarray(audio, np.float32).reshape(-1)
    original = wav.shape[0]
    chunk = int(win_duration_s * cfg.sample_rate)
    chunk = int(math.ceil(chunk / cfg.hop_length) * cfg.hop_length)  # a hop multiple
    n_chunks = max(1, math.ceil(original / chunk))
    padded = np.zeros((n_chunks * chunk,), np.float32)
    padded[:original] = wav
    device = model.quant_conv.weight.device
    batch = torch.from_numpy(padded.reshape(n_chunks, chunk, 1)).to(device)
    latents = dac_vae.encode(model, batch).mode().cpu().numpy()
    return DACFile(payload=latents, is_codes=False, sample_rate=cfg.sample_rate,
                   original_length=original, chunk_samples=chunk)


def decompress(model: DAC, artifact: DACFile, rvq: Optional[RVQ] = None) -> np.ndarray:
    """The artifact -> waveform [original_length] float32, decoded on the model's device;
    an artifact of codes needs the quantizer ``rvq`` (the JAX tree's ``params["rvq"]``)."""
    device = model.quant_conv.weight.device
    payload = torch.from_numpy(np.asarray(artifact.payload)).to(device)
    if artifact.is_codes:
        if rvq is None:
            raise ValueError("an artifact of RVQ codes decodes only with the quantizer (rvq=)")
        with torch.no_grad():
            payload = quantize.from_codes(rvq, payload)
    audio = dac_vae.decode(model, payload)
    return audio[..., 0].reshape(-1).cpu().numpy()[:artifact.original_length]
