"""The DAC codec's GAN training steps (``foley_tpu/training/dac_train.py`` counterpart).

One step updates the discriminators, then the generator (the VAE), each with optax's AdamW
arithmetic (``training/optim.py::adamw(lr, b1=0.8, b2=0.99)``):

- discriminator: the reconstruction (encode, a posterior sample, decode) without gradients,
  the LSGAN loss of the real and the fake pyramids (MPD / MSD / MRD);
- generator: a second posterior sample, then L1 + multi-scale STFT + mel + KL + LSGAN
  adversarial + feature matching on the updated discriminators, weighted as the published
  DAC recipe (mel 15, adv 1, fm 2; kl 1e-4 for the VAE branch).

Both run in ``training/train.py::step_context``: TF32 off for the convolutions' forward and
backward (cuDNN's ``allow_tf32`` defaults to True and governs the backward too) and cuDNN's
deterministic algorithms. The models' parameters are built with ``requires_grad=False``; a
step switches on exactly the leaves it differentiates, for its duration. The posterior noise
comes from the ``generator`` a step is given (``training/loop.py::step_generator`` for a
run's (seed, step)), the discriminator's draw first, or is injected as ``noise`` (the tests
pass the JAX package's draws: ``jax.random`` bits cannot be reproduced).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from foley_tpu_torch.models import dac_discriminator, dac_losses, dac_vae
from foley_tpu_torch.models.dac_discriminator import Discriminator
from foley_tpu_torch.models.dac_vae import DAC
from foley_tpu_torch.training.optim import AdamState, adamw
from foley_tpu_torch.training.train import value_and_grad


class DACTrainState(NamedTuple):
    """The generator's and the discriminators' parameters by name (the modules' own tensors,
    updated in place), their AdamW moments, and the steps taken."""

    gen_params: Dict[str, torch.Tensor]
    disc_params: Dict[str, torch.Tensor]
    gen_opt: AdamState
    disc_opt: AdamState
    step: int


class LossWeights(NamedTuple):
    waveform_l1: float = 1.0
    stft: float = 1.0
    mel: float = 15.0
    adv: float = 1.0
    feature_matching: float = 2.0
    kl: float = 1e-4


def _reconstruct(gen: DAC, audio: torch.Tensor, generator: Optional[torch.Generator],
                 noise: Optional[torch.Tensor]):
    posterior = dac_vae.encode_body(gen, audio)
    if noise is None:
        z = posterior.sample(generator)
    else:
        z = posterior.mean + posterior.std * noise.to(posterior.mean.device, torch.float32)
    return dac_vae.decode_body(gen, z), posterior


def discriminator_loss(gen: DAC, disc: Discriminator, audio: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The discriminators' LSGAN loss on the real audio and its reconstruction, the latter
    computed without gradients (the JAX step's ``stop_gradient``)."""
    with torch.no_grad():
        recon, _ = _reconstruct(gen, audio, generator, noise)
    real = dac_discriminator.apply(disc, audio)
    fake = dac_discriminator.apply(disc, recon)
    return dac_losses.discriminator_loss(real, fake)


def generator_loss(gen: DAC, disc: Discriminator, audio: torch.Tensor,
                   weights: LossWeights = LossWeights(),
                   stft_windows: Sequence[int] = (2048, 512),
                   mel_cfg: Sequence[Tuple[int, int]] = ((150, 2048), (80, 512)),
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The generator's weighted loss and its parts (``l1``, ``stft``, ``mel``, ``kl``,
    ``adv``, ``fm``) on a posterior sample."""
    recon, posterior = _reconstruct(gen, audio, generator, noise)
    x, y = recon[..., 0], audio[..., 0]
    parts = {
        "l1": dac_losses.l1_loss(x, y),
        "stft": dac_losses.multiscale_stft_loss(x, y, window_lengths=stft_windows),
        "mel": dac_losses.mel_spectrogram_loss(
            x, y, sample_rate=gen.cfg.sample_rate, n_mels=[m for m, _ in mel_cfg],
            window_lengths=[w for _, w in mel_cfg]),
        "kl": posterior.kl().mean(),
    }
    fake = dac_discriminator.apply(disc, recon)
    real = dac_discriminator.apply(disc, audio)
    parts["adv"] = dac_losses.generator_adv_loss(fake)
    parts["fm"] = dac_losses.feature_matching_loss(real, fake)
    total = (weights.waveform_l1 * parts["l1"] + weights.stft * parts["stft"]
             + weights.mel * parts["mel"] + weights.kl * parts["kl"]
             + weights.adv * parts["adv"] + weights.feature_matching * parts["fm"])
    return total, parts


def loss_and_grads(loss_fn: Callable[[], torch.Tensor], leaves: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
    """``training/train.py::value_and_grad`` with ``leaves`` requiring gradients for the
    call alone."""
    for p in leaves.values():
        p.requires_grad_(True)
    try:
        return value_and_grad(loss_fn, leaves)
    finally:
        for p in leaves.values():
            p.requires_grad_(False)


def make_dac_train_steps(gen: DAC, disc: Discriminator, weights: LossWeights = LossWeights(),
                         gen_lr: float = 1e-4, disc_lr: float = 1e-4,
                         stft_windows: Sequence[int] = (2048, 512),
                         mel_cfg: Sequence[Tuple[int, int]] = ((150, 2048), (80, 512))):
    """(init_state, train_step) for the codec ``gen`` against the discriminators ``disc``.

    ``init_state() -> DACTrainState``; ``train_step(state, audio, generator=None, *,
    noise=None) -> (state, metrics)`` with ``audio`` [B, T, 1] hop-aligned on the models'
    device and ``noise`` None or the pair (discriminator's, generator's) of standard normal
    draws of the latents' shape [B, T / hop, latent_dim]. ``metrics``: ``d_total``,
    ``g_total`` and the generator's parts (``l1``, ``stft``, ``mel``, ``kl``, ``adv``,
    ``fm``), detached scalars."""
    gen_tx = adamw(gen_lr, b1=0.8, b2=0.99)
    disc_tx = adamw(disc_lr, b1=0.8, b2=0.99)

    def init_state() -> DACTrainState:
        g, d = dict(gen.named_parameters()), dict(disc.named_parameters())
        return DACTrainState(g, d, gen_tx.init(g), disc_tx.init(d), 0)

    def train_step(state: DACTrainState, audio: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> Tuple[DACTrainState, Dict[str, torch.Tensor]]:
        """The discriminators' update, then the generator's (module docstring)."""
        noise_d, noise_g = noise if noise is not None else (None, None)
        d_loss, d_grads = loss_and_grads(
            lambda: discriminator_loss(gen, disc, audio, generator, noise_d), state.disc_params)
        disc_opt = disc_tx.update_(state.disc_params, d_grads, state.disc_opt)
        del d_grads

        parts: Dict[str, torch.Tensor] = {}

        def gen_total():
            total, out = generator_loss(gen, disc, audio, weights, stft_windows, mel_cfg,
                                        generator, noise_g)
            parts.update(out)
            return total

        g_loss, g_grads = loss_and_grads(gen_total, state.gen_params)
        gen_opt = gen_tx.update_(state.gen_params, g_grads, state.gen_opt)
        metrics = {"g_total": g_loss, "d_total": d_loss,
                   **{k: v.detach() for k, v in parts.items()}}
        return DACTrainState(state.gen_params, state.disc_params, gen_opt, disc_opt,
                             state.step + 1), metrics

    return init_state, train_step
