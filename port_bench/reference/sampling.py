"""Text-to-audio generation as HunyuanVideo-Foley's sampler defines it, in plain fp32:
the initial noise of each request drawn from its seed, the flow-matching Euler schedule
(sigmas ``linspace(1, 0, steps + 1)``, the shift of the configuration, timesteps
``sigma * 1000``), classifier-free guidance over ``[uncond; cond]`` rows
(``v = v_u + g (v_c - v_u)``), and the T2A visual placeholders: the learned empty clip and
sync features at the lengths the duration gives (``clip = duration * 8``, ``sync = ((duration
* 25 - 16) // 8 + 1) * 8``, ``nodes.py``). It imports nothing of the program.
"""

from __future__ import annotations

import torch

from port_bench.reference import mmdit


def frames(duration_s: float, rate: float) -> int:
    """``int(duration * rate)``, guarded against float noise just below a whole frame."""
    return int(duration_s * rate + 1e-6)


def t2a_lengths(pipe: dict, duration_s: float):
    """(latent frames, clip tokens, sync tokens) of a T2A request."""
    segments = (frames(duration_s, pipe["synchformer_fps"]) - 16) // 8 + 1
    return (frames(duration_s, pipe["audio_frame_rate"]),
            frames(duration_s, pipe["siglip2_fps"]), max(segments, 1) * 8)


def initial_noise(seed: int, latent_len: int, latent_dim: int, device) -> torch.Tensor:
    """A request's initial latents [1, T, C]: a standard normal draw of a generator on the
    device seeded with the request's seed (the sampler's documented rule)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((1, latent_len, latent_dim), generator=gen, device=device,
                       dtype=torch.float32)


def sigmas(diffusion: dict, steps: int, device) -> torch.Tensor:
    if diffusion["use_flux_shift"] or not diffusion["flow_reverse"]:
        raise ValueError("the reference follows the shipped schedule: reverse, no flux shift")
    s = torch.linspace(1.0, 0.0, steps + 1, dtype=torch.float64, device=device)
    shift = diffusion["sample_flow_shift"]
    if shift != 1.0:
        s = shift * s / (1.0 + (shift - 1.0) * s)
    return s.float()


@torch.no_grad()
def t2a_latents(W, config: dict, seeds, duration_s: float, steps: int, guidance: float,
                text: torch.Tensor, uncond: torch.Tensor, device, forward=mmdit.forward):
    """Final latents [N, T, C] of T2A requests of one duration, one row a seed, each
    conditioned on ``text`` / ``uncond`` [1, L, condition_dim]. ``forward`` is the denoiser
    (the reference's, unless a test puts another in its place)."""
    m, pipe = config["model"], config["pipeline"]
    latent_len, clip_len, sync_len = t2a_lengths(pipe, duration_s)
    n = len(seeds)
    lat = torch.cat([initial_noise(s, latent_len, m["audio_vae_latent_dim"], device)
                     for s in seeds])
    cond = torch.cat([uncond.expand(n, -1, -1), text.expand(n, -1, -1)]).to(device)
    clip = W["empty_clip_feat"][None].expand(2 * n, clip_len, -1)
    sync = W["empty_sync_feat"][None].expand(2 * n, sync_len, -1)
    sig = sigmas(config["diffusion"], steps, device)
    for i in range(steps):
        t = (sig[i] * config["diffusion"]["num_train_timesteps"]).expand(2 * n)
        v = forward(W, m, torch.cat([lat, lat]), t, cond, clip, sync)
        v_u, v_c = v.chunk(2)
        lat = lat + (v_u + guidance * (v_c - v_u)) * (sig[i + 1] - sig[i])
    return lat
