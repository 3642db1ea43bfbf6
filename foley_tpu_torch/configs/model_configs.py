"""Typed model/pipeline configs: the port's own copy of ``foley_tpu/configs/model_configs.py``.

The same frozen dataclasses and presets as the JAX package, kept here so the port imports
nothing of it. ``config_from_yaml`` reads the reference-format YAMLs (copies of the JAX
package's under ``configs/yaml/``) through the port's own reader of their YAML subset
(``utils/config_utils.py``): the machine with the card has no ``yaml``.

Known reference inconsistencies are resolved per SURVEY.md Appendix B:
- block depth comes from the config (18+36 for XXL), not the class defaults (19/38);
- the audio latent frame rate is 50 (= 48000 / prod(DAC rates)), not ``constants.py:16``'s 75.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Tuple

from foley_tpu_torch.utils.config_utils import load_yaml

#: The reference-format YAMLs of the shipped configs (``xl``, ``xxl``).
YAML_DIR = Path(__file__).resolve().parent / "yaml"


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """HunyuanVideoFoley denoiser architecture (reference ``hifi_foley.py:392-527``)."""

    depth_triple_blocks: int = 18
    depth_single_blocks: int = 36
    hidden_size: int = 1536
    num_heads: int = 12
    mlp_ratio: float = 4.0
    mlp_act_type: str = "gelu_tanh"
    qkv_bias: bool = True
    qk_norm: bool = True
    qk_norm_type: str = "rms"
    qk_norm_eps: float = 1e-6
    interleaved_audio_visual_rope: bool = True
    sync_modulation: bool = False
    add_sync_feat_to_audio: bool = True
    use_attention_mask: bool = False
    condition_dim: int = 768        # CLAP text feature dim
    clip_dim: int = 768             # SigLIP2 visual feature dim
    sync_feat_dim: int = 768        # Synchformer feature dim
    audio_vae_latent_dim: int = 128
    audio_frame_rate: int = 50      # latent frames / second (48000 / (2*3*4*5*8))
    patch_size: int = 1
    rope_theta: float = 10000.0
    text_length: int = 77
    clip_length: int = 64
    sync_length: int = 192
    sync_in_ksz: int = 1
    # ConvMLP hidden rounding (reference mlp_layers.py:141-142)
    conv_mlp_multiple_of: int = 256

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def conv_mlp_hidden_dim(self) -> int:
        """SwiGLU-style ConvMLP hidden: round 2/3*mlp_hidden up to multiple_of."""
        hidden = int(2 * self.mlp_hidden_dim / 3)
        m = self.conv_mlp_multiple_of
        return m * ((hidden + m - 1) // m)


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Flow-matching sampling knobs (reference yaml ``diffusion_config``)."""

    num_train_timesteps: int = 1000
    sample_flow_shift: float = 1.0
    flow_reverse: bool = True
    flow_solver: str = "euler"
    use_flux_shift: bool = False
    flux_base_shift: float = 0.5
    flux_max_shift: float = 1.15


@dataclasses.dataclass(frozen=True)
class DACConfig:
    """Continuous DAC-VAE (reference ``utils.py:32-44`` `_DAC_KWARGS`)."""

    encoder_dim: int = 128
    encoder_rates: Tuple[int, ...] = (2, 3, 4, 5, 8)
    latent_dim: int = 128
    decoder_dim: int = 2048
    decoder_rates: Tuple[int, ...] = (8, 5, 4, 3, 2)
    sample_rate: int = 48000
    continuous: bool = True

    @property
    def hop_length(self) -> int:
        hop = 1
        for r in self.encoder_rates:
            hop *= r
        return hop


@dataclasses.dataclass(frozen=True)
class SynchformerConfig:
    """MotionFormer video half of Synchformer (reference ``divided_224_16x4.yaml:45-64``)."""

    img_size: int = 224
    patch_size: int = 16
    temporal_patch_size: int = 2
    num_frames: int = 16          # frames per segment
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    segment_stride: int = 8       # 16-frame windows, stride 8 (feature_utils.py:91-97)
    out_features_per_segment: int = 8  # temporal positions after temporal patching

    @property
    def temporal_resolution(self) -> int:
        return self.num_frames // self.temporal_patch_size

    @property
    def patches_per_frame(self) -> int:
        return (self.img_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class ClapTextConfig:
    """CLAP text tower, laion/larger_clap_general (``foley_tpu/models/clap.py``): a RoBERTa
    post-LN encoder whose last hidden state is the 768-d text condition."""

    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls) -> "ClapTextConfig":
        return cls(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=64, max_position_embeddings=20)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end generation configuration (reference node widget schema nodes.py:213-237)."""

    model: MMDiTConfig = MMDiTConfig()
    diffusion: DiffusionConfig = DiffusionConfig()
    dac: DACConfig = DACConfig()
    # Visual feature rates (reference constants.py FPS_VISUAL)
    siglip2_fps: int = 8
    synchformer_fps: int = 25
    # Defaults (reference constants.py:29-34)
    default_guidance_scale: float = 4.5
    default_num_inference_steps: int = 50
    default_negative_prompt: str = "noisy, harsh"
    max_duration_s: float = 60.0
    min_duration_s: float = 1.0

    def t2a_lengths(self, duration_s: float) -> Tuple[int, int]:
        """(clip_seq_len, sync_seq_len) for text-to-audio empty sequences.

        Reference nodes.py:326-333: clip_len = duration*8;
        num_sync_segments = (duration*25 - 16)//8 + 1; sync_len = segments*8.
        """
        clip_len = _frames(duration_s, self.siglip2_fps)
        num_sync_segments = (_frames(duration_s, self.synchformer_fps) - 16) // 8 + 1
        sync_len = max(num_sync_segments, 1) * 8
        return clip_len, sync_len

    def latent_length(self, duration_s: float) -> int:
        return _frames(duration_s, self.model.audio_frame_rate)


def _frames(duration_s: float, rate: float) -> int:
    """Reference truncation (``int(duration * fps)``, nodes.py:326-333) with a float-noise
    guard: durations that round-trip through seconds (e.g. long-form plans returning
    ``total_frames / 50``) can land epsilon BELOW the exact product (1/50 is not dyadic),
    and plain ``int()`` would silently drop a frame, desyncing feature lengths from the
    window schedule. The epsilon only rescues float noise — it never changes the result
    for any duration distinguishable at ~1e-6 s."""
    return int(duration_s * rate + 1e-6)


# ---------------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------------

XXL = PipelineConfig(model=MMDiTConfig())

XL = PipelineConfig(
    model=MMDiTConfig(
        depth_triple_blocks=12,
        depth_single_blocks=24,
        hidden_size=1408,
        num_heads=11,
    )
)

# Tiny config for tests / CI compile checks: same code paths, tiny dims.
TINY = PipelineConfig(
    model=MMDiTConfig(
        depth_triple_blocks=2,
        depth_single_blocks=4,
        hidden_size=64,
        num_heads=2,
        condition_dim=16,
        clip_dim=16,
        sync_feat_dim=16,
        audio_vae_latent_dim=8,
        conv_mlp_multiple_of=16,
        text_length=16,
    ),
    dac=DACConfig(
        encoder_dim=8,
        encoder_rates=(2, 3, 4, 5, 8),
        latent_dim=8,
        decoder_dim=64,
        decoder_rates=(8, 5, 4, 3, 2),
    ),
)

_PRESETS = {"xxl": XXL, "xl": XL, "tiny": TINY}


def get_config(name: str) -> PipelineConfig:
    key = name.lower().replace("hunyuanvideo-foley-", "")
    if key not in _PRESETS:
        raise KeyError(f"Unknown config {name!r}; available: {sorted(_PRESETS)}")
    return _PRESETS[key]


def config_from_yaml(path: str) -> PipelineConfig:
    """Parse a reference-format YAML (``configs/hunyuanvideo-foley-*.yaml``) into typed configs."""
    raw = load_yaml(path)
    mk = raw.model_config.model_kwargs
    model = MMDiTConfig(
        depth_triple_blocks=int(mk.get("depth_triple_blocks", 18)),
        depth_single_blocks=int(mk.get("depth_single_blocks", 36)),
        hidden_size=int(mk.get("hidden_size", 1536)),
        num_heads=int(mk.get("num_heads", 12)),
        mlp_ratio=float(mk.get("mlp_ratio", 4.0)),
        mlp_act_type=str(mk.get("mlp_act_type", "gelu_tanh")),
        qkv_bias=bool(mk.get("qkv_bias", True)),
        qk_norm=bool(mk.get("qk_norm", True)),
        qk_norm_type=str(mk.get("qk_norm_type", "rms")),
        interleaved_audio_visual_rope=bool(mk.get("interleaved_audio_visual_rope", False)),
        sync_modulation=bool(mk.get("sync_modulation", False)),
        add_sync_feat_to_audio=bool(mk.get("add_sync_feat_to_audio", False)),
        use_attention_mask=bool(mk.get("use_attention_mask", False)),
        condition_dim=int(mk.get("condition_dim", 768)),
        clip_dim=int(mk.get("clip_dim", 768)),
        sync_feat_dim=int(mk.get("sync_feat_dim", 768)),
        audio_vae_latent_dim=int(mk.get("audio_vae_latent_dim", 128)),
        audio_frame_rate=int(mk.get("audio_frame_rate", 50)),
        patch_size=int(mk.get("patch_size", 1)),
        rope_theta=float(mk.get("rope_theta", 10000)),
        text_length=int(mk.get("text_length", 77)),
        clip_length=int(mk.get("clip_length", 64)),
        sync_length=int(mk.get("sync_length", 192)),
    )
    dc = raw.get("diffusion_config", None)
    diffusion = DiffusionConfig(
        sample_flow_shift=float(dc.get("sample_flow_shift", 1.0)) if dc else 1.0,
        flow_reverse=bool(dc.get("flow_reverse", True)) if dc else True,
        flow_solver=str(dc.get("flow_solver", "euler")) if dc else "euler",
        use_flux_shift=bool(dc.get("sample_use_flux_shift", False)) if dc else False,
        flux_base_shift=float(dc.get("flux_base_shift", 0.5)) if dc else 0.5,
        flux_max_shift=float(dc.get("flux_max_shift", 1.15)) if dc else 1.15,
    )
    return PipelineConfig(model=model, diffusion=diffusion)
