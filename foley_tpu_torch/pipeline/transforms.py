"""AV data transforms, the Synchformer train / eval suite (``foley_tpu/pipeline/
transforms.py`` counterpart; reference ``synchformer/data_transforms.py``).

Composable host-side (numpy) transforms: temporal crop with offset-grid targets (and the
syncability-training variant), stream equalisation and frame / sample-rate resampling,
segment generation, spatial crops and letterboxes (square and rectangular), colour
distortion (per clip and per frame), flips and grayscale, audio volume / lowpass /
pitch-shift / reverb / noise augmentations, mel + log + pad + AST normalisation, stream
permutes and the identity. Items are dicts with ``frames`` [T, H, W, C] float [0, 1],
``audio`` [T'] float, optional ``vfps`` / ``afps``. Augmentation is data-loader work: the
numpy code and its ``np.random.Generator`` draws are the JAX package's, line for line, so
one seed gives the same items in both packages.

Two kinds of step run in torch, on the ``device`` a transform is given (``cuda`` unless
the caller names another): the frame resizes, where the JAX package calls
``PIL.Image.resize`` on each frame quantised as ``(clip(f, 0, 1) * 255).astype(uint8)``,
go through ``ops/pil_resize.py``, Pillow's 8-bit resampler, equal to it byte for byte on
the CPU and on the card (the card's machine has no PIL); and ``AudioMelSpectrogram`` is
``ops/audio_dsp.py::sync_audio_spectrogram`` (cuFFT on the card, whose bins differ from
XLA's FFT in the last places).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.ops import pil_resize
from foley_tpu_torch.ops.audio_dsp import sync_audio_spectrogram


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, item):
        for t in self.transforms:
            item = t(item)
        return item


# ---------------------------------------------------------------------------------
# Temporal transforms
# ---------------------------------------------------------------------------------

@dataclasses.dataclass
class TemporalCropAndOffset:
    """Crop a clip to ``crop_len_s`` and draw an AV offset from the class grid
    (reference EqualifyFromRight/TemporalCropAndOffsetRGB behavior family).

    Returns (frames, audio, offset_target_idx): audio is shifted by -offset relative to
    video, and the grid index is the classification target for the sync scorer.
    """

    crop_len_s: float = 5.0
    vfps: float = 25.0
    afps: int = 16000
    grid: Optional[np.ndarray] = None  # offset grid in seconds (default: ±2 s, 21 classes)
    rng: Optional[np.random.Generator] = None

    def __post_init__(self):
        if self.grid is None:
            from foley_tpu_torch.models.sync_scorer import make_class_grid

            self.grid = make_class_grid()
        self.rng = self.rng or np.random.default_rng()

    def _eval_crop(self, item: dict, offset_s: float, v_start_s: float) -> dict:
        """Fixed-offset eval/test branch (reference ``data_transforms.py:333-337,366-423``):
        valid/test datasets carry ``offset_sec``/``v_start_i_sec`` targets and the crop is
        fully deterministic — ``sec2frames`` truncation (int(sec*fps)), the small-negative
        a_start fix (:382-389), and grid quantization of the provided offset. Frame rates
        come from the item when carried (resample transforms update them), like the
        reference's meta reads (:326-327)."""
        from foley_tpu_torch.models.sync_scorer import quantize_offset

        vfps = float(item.get("vfps", self.vfps))
        afps = float(item.get("afps", self.afps))
        offset_s = round(float(offset_s), 2)
        n_v = int(self.crop_len_s * vfps)
        n_a = int(self.crop_len_s * afps)
        v_start = int(v_start_s * vfps)
        a_start = int((v_start_s + offset_s) * afps)
        if a_start < 0:
            if abs(a_start) > afps / vfps:
                raise ValueError(f"a_start_i {a_start} out of the rounding-error fix range")
            a_start = 0  # reference: a_start_i += abs(how_much_out)
        frames, audio = item["frames"], item["audio"]
        assert frames.shape[0] >= v_start + n_v and audio.shape[-1] >= a_start + n_a, (
            frames.shape, audio.shape, v_start, a_start)
        offset_label, offset_idx = quantize_offset(self.grid, offset_s)
        out = dict(item)
        out["frames"] = frames[v_start : v_start + n_v]
        out["audio"] = audio[..., a_start : a_start + n_a]
        out["offset_sec"] = offset_s
        out["offset_label"] = offset_label
        out["offset_target"] = offset_idx
        out["v_start_i_sec"] = float(v_start_s)
        return out

    def __call__(self, item: dict) -> dict:
        has_off = item.get("offset_sec") is not None
        has_start = item.get("v_start_i_sec") is not None
        if has_off or has_start:
            # either key present marks a fixed-offset eval item (reference requires BOTH
            # None to take the train branch, :339); half-set targets fail loudly instead of
            # silently overwriting the provided one with a random draw
            if not (has_off and has_start):
                raise ValueError(
                    "fixed-offset item must carry BOTH offset_sec and v_start_i_sec "
                    f"(got offset_sec={item.get('offset_sec')!r}, "
                    f"v_start_i_sec={item.get('v_start_i_sec')!r})"
                )
            return self._eval_crop(item, item["offset_sec"], item["v_start_i_sec"])
        frames, audio = item["frames"], item["audio"]
        n_v = int(self.crop_len_s * self.vfps)
        n_a = int(self.crop_len_s * self.afps)
        offset_idx = int(self.rng.integers(0, len(self.grid)))
        offset_s = float(self.grid[offset_idx])

        max_v_start = max(frames.shape[0] - n_v, 0)
        v_start = int(self.rng.integers(0, max_v_start + 1))
        a_start = int(round((v_start / self.vfps + offset_s) * self.afps))
        a_start = int(np.clip(a_start, 0, max(audio.shape[-1] - n_a, 0)))

        out = dict(item)
        out["frames"] = _pad_take(frames, v_start, n_v, axis=0)
        out["audio"] = _pad_take(audio, a_start, n_a, axis=-1)
        out["offset_sec"] = offset_s
        out["offset_target"] = offset_idx
        return out


def _resize(frames: np.ndarray, width: int, height: int, kind: str,
            device: DeviceLike) -> np.ndarray:
    """Every frame as the JAX package resizes it through PIL: ``[T, H, W, C]`` float ->
    ``(clip(f, 0, 1) * 255).astype(uint8)`` -> ``Image.resize((width, height), kind)`` ->
    float32 / 255, the resize on ``device``."""
    u8 = torch.from_numpy((np.clip(frames, 0, 1) * 255).astype(np.uint8))
    out = pil_resize.resize(u8.to(resolve_device(device)), (width, height), kind)
    return np.asarray(out.cpu().numpy(), np.float32) / 255.0


def _pad_take(x: np.ndarray, start: int, length: int, axis: int) -> np.ndarray:
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(start, start + length)
    out = x[tuple(sl)]
    if out.shape[axis] < length:
        pad = [(0, 0)] * x.ndim
        pad[axis] = (0, length - out.shape[axis])
        out = np.pad(out, pad, mode="edge" if x.ndim > 1 else "constant")
    return out


@dataclasses.dataclass
class GenerateMultipleSegments:
    """Segment the AV streams into aligned windows — 16 video frames / 0.64 s audio at the
    Synchformer geometry (reference GenerateMultipleSegments, data_transforms.py:437-542):
    the segment count is shared across streams (min of what each accommodates, or an explicit
    ``n_segments``), the first segment starts centered (``max_start // 2``) or uniformly at
    random, and ``audio_jitter_sec`` shifts every audio window by one shared draw. All frame
    index math follows the reference exactly (``int`` truncation through seconds).
    The inference-path variant (start 0, audio-independent) remains ``features.sync_segments``,
    which mirrors ``feature_utils.py`` instead of this training transform."""

    segment_size_vframes: int = 16
    stride_vframes: int = 8          # video stride; step_size_seg overrides with ref math
    vfps: float = 25.0
    afps: int = 16000
    n_segments: Optional[int] = None
    is_start_random: bool = False
    audio_jitter_sec: float = 0.0
    step_size_seg: Optional[float] = None  # reference parameterization: strides = int(step*seg)
    rng: Optional[np.random.Generator] = None

    def __call__(self, item: dict) -> dict:
        vfps = int(item.get("vfps", self.vfps))
        afps = int(item.get("afps", self.afps))
        frames = item["frames"]
        v_len = frames.shape[0]

        seg_v = self.segment_size_vframes
        seg_a = int(seg_v / vfps * afps)                       # sec2frames(frames2sec(seg_v))
        if self.step_size_seg is not None:
            # reference math exactly: both strides truncate step * segment size
            step = self.step_size_seg
            stride_v = int(step * seg_v)
        else:
            # integer-stride ctor: honor the configured video stride verbatim (a float
            # roundtrip int(stride/seg*seg) loses a frame for pairs like seg=22, stride=15)
            stride_v = self.stride_vframes
            step = stride_v / seg_v
        stride_a = int(step * seg_a)

        audio = None
        n_max = (v_len - seg_v) // stride_v + 1
        if "audio" in item:
            audio = np.asarray(item["audio"]).reshape(-1)
            n_max = min(n_max, (audio.shape[0] - seg_a) // stride_a + 1)
        n = n_max if self.n_segments is None else self.n_segments
        assert 1 <= n <= n_max, (n, n_max, v_len)

        # temporal placement of the whole segment sequence: centered or random start
        seg_seq_len = n * step + (1 - step)
        v_seq_len = int(seg_seq_len * seg_v)
        a_seq_len = int(seg_seq_len * seg_a)
        max_v_start = v_len - v_seq_len
        rng = self.rng or np.random.default_rng()
        v_start = int(rng.integers(0, max_v_start + 1)) if self.is_start_random else max_v_start // 2

        out = dict(item)
        v_starts = v_start + stride_v * np.arange(n)
        out["v_segments"] = np.stack([frames[s : s + seg_v] for s in v_starts], axis=0)
        if audio is None:
            return out  # video-only item: segment the frames alone

        a_len = audio.shape[0]
        a_start = int(v_start / vfps * afps)
        a_starts = a_start + stride_a * np.arange(n)
        if self.audio_jitter_sec > 0:
            jit = int(self.audio_jitter_sec * afps)
            jit = min(jit, a_start, a_len - a_start - a_seq_len)
            a_starts = a_starts + int(rng.integers(-jit, jit + 1))

        # the centered start is derived from the VIDEO stream; when the audio is shorter it
        # may not accommodate the sequence — the reference asserts (data_transforms.py:540)
        assert a_starts[0] >= 0 and a_starts[-1] + seg_a <= a_len, (a_starts, a_len)
        out["a_segments"] = np.stack([audio[s : s + seg_a] for s in a_starts], axis=0)
        return out


# ---------------------------------------------------------------------------------
# Visual transforms
# ---------------------------------------------------------------------------------

@dataclasses.dataclass
class ResizeAndLetterbox:
    """Resize keeping aspect ratio then pad to square (reference letterbox aug)."""

    size: int = 224
    device: DeviceLike = None

    def __call__(self, item: dict) -> dict:
        frames = item["frames"]
        out_frames = np.zeros((frames.shape[0], self.size, self.size, frames.shape[-1]), np.float32)
        h, w = frames.shape[1:3]
        scale = self.size / max(w, h)
        nw, nh = max(round(w * scale), 1), max(round(h * scale), 1)
        top, left = (self.size - nh) // 2, (self.size - nw) // 2
        out_frames[:, top : top + nh, left : left + nw] = _resize(
            frames, nw, nh, pil_resize.BICUBIC, self.device)
        out = dict(item)
        out["frames"] = out_frames
        return out


@dataclasses.dataclass
class RandomResizedCropFrames:
    """Consistent random resized crop across all frames of a clip (training aug)."""

    size: int = 224
    scale: Tuple[float, float] = (0.5, 1.0)
    rng: Optional[np.random.Generator] = None
    device: DeviceLike = None

    def __call__(self, item: dict) -> dict:
        rng = self.rng or np.random.default_rng()
        frames = item["frames"]
        t, h, w, c = frames.shape
        area = float(rng.uniform(*self.scale)) * h * w
        side = int(np.sqrt(area))
        side = min(side, h, w)
        top = int(rng.integers(0, h - side + 1))
        left = int(rng.integers(0, w - side + 1))
        crop = frames[:, top : top + side, left : left + side]
        out_frames = _resize(crop, self.size, self.size, pil_resize.BICUBIC, self.device)
        out = dict(item)
        out["frames"] = out_frames
        return out


@dataclasses.dataclass
class ColorJitterFrames:
    """Brightness/contrast/saturation jitter, one draw per clip (training aug)."""

    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    rng: Optional[np.random.Generator] = None

    def __call__(self, item: dict) -> dict:
        rng = self.rng or np.random.default_rng()
        f = item["frames"].astype(np.float32)
        b = 1.0 + float(rng.uniform(-self.brightness, self.brightness))
        c = 1.0 + float(rng.uniform(-self.contrast, self.contrast))
        s = 1.0 + float(rng.uniform(-self.saturation, self.saturation))
        f = f * b
        mean = f.mean(axis=(1, 2, 3), keepdims=True)
        f = (f - mean) * c + mean
        gray = f.mean(axis=-1, keepdims=True)
        f = (f - gray) * s + gray
        out = dict(item)
        out["frames"] = np.clip(f, 0.0, 1.0)
        return out


@dataclasses.dataclass
class RandomHorizontalFlipFrames:
    p: float = 0.5
    rng: Optional[np.random.Generator] = None

    def __call__(self, item: dict) -> dict:
        rng = self.rng or np.random.default_rng()
        out = dict(item)
        if rng.random() < self.p:
            out["frames"] = item["frames"][:, :, ::-1].copy()
        return out


@dataclasses.dataclass
class NormalizeFrames:
    """(x - mean) / std per channel (reference uses 0.5/0.5 for Synchformer)."""

    mean: float = 0.5
    std: float = 0.5

    def __call__(self, item: dict) -> dict:
        out = dict(item)
        out["frames"] = (item["frames"].astype(np.float32) - self.mean) / self.std
        return out


# ---------------------------------------------------------------------------------
# Audio transforms
# ---------------------------------------------------------------------------------

@dataclasses.dataclass
class RandomAudioGain:
    min_db: float = -6.0
    max_db: float = 6.0
    rng: Optional[np.random.Generator] = None

    def __call__(self, item: dict) -> dict:
        rng = self.rng or np.random.default_rng()
        gain = 10 ** (float(rng.uniform(self.min_db, self.max_db)) / 20.0)
        out = dict(item)
        out["audio"] = np.clip(item["audio"] * gain, -1.0, 1.0)
        return out


@dataclasses.dataclass
class AddGaussianNoise:
    snr_db: float = 30.0
    rng: Optional[np.random.Generator] = None

    def __call__(self, item: dict) -> dict:
        rng = self.rng or np.random.default_rng()
        audio = item["audio"].astype(np.float32)
        sig_power = np.mean(audio ** 2) + 1e-12
        noise_power = sig_power / (10 ** (self.snr_db / 10.0))
        noise = rng.normal(0.0, np.sqrt(noise_power), audio.shape).astype(np.float32)
        out = dict(item)
        out["audio"] = audio + noise
        return out


class AudioMelSpectrogram:
    """Synchformer audio spec: mel -> log -> pad/trim 66 -> AST normalize
    (``ops/audio_dsp.py::sync_audio_spectrogram`` on ``device``, back as numpy)."""

    def __init__(self, device: DeviceLike = None):
        self.device = device

    def __call__(self, item: dict) -> dict:
        out = dict(item)
        segs = item.get("a_segments", item["audio"][None])
        x = torch.from_numpy(np.asarray(segs, np.float32)).to(resolve_device(self.device))
        out["a_spec"] = sync_audio_spectrogram(x).cpu().numpy()
        return out


@dataclasses.dataclass
class AudioRandomVolume:
    """Apply a fixed gain with probability p (reference AudioRandomVolume,
    data_transforms.py:723-745: torchaudio Vol wrapped in RandomApply)."""

    p: float = 0.5
    gain: float = 2.0
    gain_type: str = "amplitude"  # amplitude | db | power
    rng: Optional[np.random.Generator] = None

    def __call__(self, item: dict) -> dict:
        rng = self.rng or np.random.default_rng()
        if rng.random() >= self.p:
            return item
        g = self.gain
        if self.gain_type == "db":
            g = 10 ** (self.gain / 20.0)
        elif self.gain_type == "power":
            g = self.gain ** 0.5
        out = dict(item)
        out["audio"] = np.clip(item["audio"] * g, -1.0, 1.0)
        return out


@dataclasses.dataclass
class AudioRandomLowpassFilter:
    """Biquad lowpass with probability p (reference AudioRandomLowpassFilter,
    data_transforms.py:748-775; same coefficients as torchaudio.functional.lowpass_biquad)."""

    p: float = 0.5
    cutoff_freq: float = 4000.0
    Q: float = 0.707
    rng: Optional[np.random.Generator] = None

    def __call__(self, item: dict) -> dict:
        rng = self.rng or np.random.default_rng()
        if rng.random() >= self.p:
            return item
        from scipy.signal import lfilter

        sr = float(item.get("afps", 16000))
        w0 = 2.0 * np.pi * self.cutoff_freq / sr
        alpha = np.sin(w0) / (2.0 * self.Q)
        cosw = np.cos(w0)
        b = np.array([(1 - cosw) / 2.0, 1 - cosw, (1 - cosw) / 2.0])
        a = np.array([1 + alpha, -2 * cosw, 1 - alpha])
        out = dict(item)
        out["audio"] = lfilter(b / a[0], a / a[0], item["audio"].astype(np.float64),
                               axis=-1).astype(np.float32)
        return out


@dataclasses.dataclass
class AudioRandomPitchShift:
    """Pitch shift by ``shift`` cents with probability p, preserving length (reference
    AudioRandomPitchShift, data_transforms.py:778-806: sox 'pitch' effect). STFT phase-vocoder
    time stretch by 2^(cents/1200) followed by linear resampling back to the original rate."""

    p: float = 0.5
    shift: int = 400  # cents
    n_fft: int = 1024
    rng: Optional[np.random.Generator] = None

    def __call__(self, item: dict) -> dict:
        rng = self.rng or np.random.default_rng()
        if rng.random() >= self.p:
            return item
        out = dict(item)
        out["audio"] = self._pitch_shift(item["audio"].astype(np.float32).reshape(-1))
        return out

    def _pitch_shift(self, x: np.ndarray) -> np.ndarray:
        rate = 2.0 ** (self.shift / 1200.0)
        hop = self.n_fft // 4
        window = np.hanning(self.n_fft).astype(np.float32)
        n_frames = max(1 + (len(x) - self.n_fft) // hop, 1)
        pad = self.n_fft + (n_frames - 1) * hop - len(x)
        xp = np.pad(x, (0, max(pad, 0)))
        frames = np.stack([xp[i * hop : i * hop + self.n_fft] for i in range(n_frames)])
        spec = np.fft.rfft(frames * window, axis=-1)

        # phase-vocoder time stretch to duration*rate (pitch preserved), so the final
        # resample back to the original length speeds playback by `rate` -> pitch * rate
        t_idx = np.arange(0, n_frames, 1.0 / rate)
        omega = 2.0 * np.pi * hop * np.arange(spec.shape[1]) / self.n_fft
        lo = np.minimum(t_idx.astype(np.int64), n_frames - 1)
        hi = np.minimum(lo + 1, n_frames - 1)
        frac = (t_idx - lo)[:, None]
        mag = (1 - frac) * np.abs(spec[lo]) + frac * np.abs(spec[hi])
        dphi = np.angle(spec[hi]) - np.angle(spec[lo]) - omega
        dphi -= 2.0 * np.pi * np.round(dphi / (2.0 * np.pi))
        phase = np.cumsum(np.concatenate([np.angle(spec[lo[:1]]), (omega + dphi)[:-1]], axis=0),
                          axis=0)
        stretched = mag * np.exp(1j * phase)

        # overlap-add inverse STFT
        y_frames = np.fft.irfft(stretched, n=self.n_fft, axis=-1) * window
        y = np.zeros(self.n_fft + (len(t_idx) - 1) * hop, np.float32)
        norm = np.zeros_like(y)
        for i, f in enumerate(y_frames):
            y[i * hop : i * hop + self.n_fft] += f.astype(np.float32)
            norm[i * hop : i * hop + self.n_fft] += window ** 2
        y = y / np.maximum(norm, 1e-8)

        # resample the stretched signal back to the original length -> pitch moved by `rate`
        src = np.linspace(0.0, len(y) - 1.0, num=len(x))
        return np.interp(src, np.arange(len(y)), y).astype(np.float32)


@dataclasses.dataclass
class AudioRandomReverb:
    """Reverb with probability p (reference AudioRandomReverb, data_transforms.py:809-836:
    sox 'reverb -w'). Convolution with a synthetic exponentially-decaying noise impulse
    response (FFT convolve), length-preserving, energy-normalized."""

    p: float = 0.5
    rt60_s: float = 0.5
    ir_len_s: float = 0.6
    wet: float = 0.5
    rng: Optional[np.random.Generator] = None

    def __call__(self, item: dict) -> dict:
        rng = self.rng or np.random.default_rng()
        if rng.random() >= self.p:
            return item
        from scipy.signal import fftconvolve

        sr = float(item.get("afps", 16000))
        n_ir = max(int(self.ir_len_s * sr), 8)
        t = np.arange(n_ir) / sr
        ir = rng.standard_normal(n_ir).astype(np.float32) * np.exp(
            -6.908 * t / self.rt60_s  # -60 dB at rt60
        ).astype(np.float32)
        ir[0] = 1.0
        ir /= np.sqrt(np.sum(ir ** 2)) + 1e-8
        audio = item["audio"].astype(np.float32)
        wet_sig = fftconvolve(audio, ir, mode="full", axes=-1)[..., : audio.shape[-1]]
        out = dict(item)
        out["audio"] = ((1.0 - self.wet) * audio + self.wet * wet_sig).astype(np.float32)
        return out


@dataclasses.dataclass
class AudioRandomGaussNoise:
    """Add fixed-amplitude Gaussian noise with probability p (reference AudioRandomGaussNoise,
    data_transforms.py:839-864; AddGaussianNoise above is the SNR-targeted variant)."""

    p: float = 0.5
    amplitude: float = 0.01
    rng: Optional[np.random.Generator] = None

    def __call__(self, item: dict) -> dict:
        rng = self.rng or np.random.default_rng()
        if rng.random() >= self.p:
            return item
        out = dict(item)
        audio = item["audio"].astype(np.float32)
        out["audio"] = audio + self.amplitude * rng.standard_normal(audio.shape).astype(np.float32)
        return out


@dataclasses.dataclass
class AudioLog:
    """log(spec + eps) on the spectrogram (reference AudioLog, data_transforms.py:878-886)."""

    eps: float = 1e-6

    def __call__(self, item: dict) -> dict:
        out = dict(item)
        out["a_spec"] = np.log(item["a_spec"] + self.eps)
        return out


@dataclasses.dataclass
class PadOrTruncate:
    """Pad/trim the spectrogram time axis to ``max_spec_t`` (reference PadOrTruncate,
    data_transforms.py:889-911; 66 for the Synchformer AST windows)."""

    max_spec_t: int = 66
    pad_value: float = 0.0

    def __call__(self, item: dict) -> dict:
        spec = item["a_spec"]
        diff = self.max_spec_t - spec.shape[-1]
        if diff > 0:
            pad = [(0, 0)] * (spec.ndim - 1) + [(0, diff)]
            spec = np.pad(spec, pad, constant_values=self.pad_value)
        elif diff < 0:
            spec = spec[..., : self.max_spec_t]
        out = dict(item)
        out["a_spec"] = spec
        return out


@dataclasses.dataclass
class AudioNormalizeAST:
    """(x - mean) / (2 * std) — AST's doubled-std normalization (reference AudioNormalizeAST,
    data_transforms.py:914-925)."""

    mean: float = -4.2677393
    std: float = 4.5689974

    def __call__(self, item: dict) -> dict:
        out = dict(item)
        out["a_spec"] = (item["a_spec"] - self.mean) / (2.0 * self.std)
        return out


@dataclasses.dataclass
class ResampleAudio:
    """Linear resample to ``new_fps`` (reference ResampleAudio, data_transforms.py:946-958)."""

    new_fps: int = 16000

    def __call__(self, item: dict) -> dict:
        orig = int(item.get("afps", 16000))
        out = dict(item)
        if orig != self.new_fps:
            audio = np.asarray(item["audio"], np.float32)
            n_new = int(round(audio.shape[-1] * self.new_fps / orig))
            src = np.linspace(0.0, audio.shape[-1] - 1.0, num=n_new)
            out["audio"] = np.interp(src, np.arange(audio.shape[-1]), audio).astype(np.float32)
        out["afps"] = self.new_fps
        return out


@dataclasses.dataclass
class ResampleRGB:
    """Nearest-index frame-rate resample (reference ResampleRGB, data_transforms.py:961-977)."""

    new_fps: float = 25.0

    def __call__(self, item: dict) -> dict:
        orig = float(item.get("vfps", 25.0))
        out = dict(item)
        if orig != self.new_fps:
            frames = item["frames"]
            duration = frames.shape[0] / orig
            idx = np.arange(0.0, orig * duration - 1e-9, orig / self.new_fps).astype(np.int64)
            out["frames"] = frames[np.minimum(idx, frames.shape[0] - 1)]
        out["vfps"] = self.new_fps
        return out


@dataclasses.dataclass
class ResizeAndLetterboxPad:
    """Aspect-preserving resize + centered zero letterbox to (new_h, new_w) (reference
    ResizeAndLetterboxPad, data_transforms.py:980-1008; generalizes the square
    ResizeAndLetterbox above to rectangular targets)."""

    new_h: int = 224
    new_w: int = 224
    device: DeviceLike = None

    def __call__(self, item: dict) -> dict:
        frames = item["frames"]
        t, h, w, c = frames.shape
        scale = min(self.new_h / h, self.new_w / w)
        nh, nw = max(round(h * scale), 1), max(round(w * scale), 1)
        top, left = (self.new_h - nh) // 2, (self.new_w - nw) // 2
        out_frames = np.zeros((t, self.new_h, self.new_w, c), np.float32)
        out_frames[:, top : top + nh, left : left + nw] = _resize(
            frames, nw, nh, pil_resize.BILINEAR, self.device)
        out = dict(item)
        out["frames"] = out_frames
        return out


@dataclasses.dataclass
class ResampleResizeLetterboxPad:
    """Audio resample + video fps resample + letterbox, composed (reference
    ResampleResizeLetterboxPad, data_transforms.py:1011-1020)."""

    afps: int = 16000
    vfps: float = 25.0
    new_h: int = 224
    new_w: int = 224
    device: DeviceLike = None

    def __call__(self, item: dict) -> dict:
        pipe = Compose([
            ResampleAudio(new_fps=self.afps),
            ResampleRGB(new_fps=self.vfps),
            ResizeAndLetterboxPad(new_h=self.new_h, new_w=self.new_w, device=self.device),
        ])
        return pipe(item)


@dataclasses.dataclass
class PermuteStreams:
    """einops rearrange of the audio/frames streams (reference PermuteStreams,
    data_transforms.py:928-943)."""

    einops_order_audio: Optional[str] = None
    einops_order_rgb: Optional[str] = None

    def __call__(self, item: dict) -> dict:
        import einops

        out = dict(item)
        if self.einops_order_audio:
            key = "a_spec" if "a_spec" in item else "audio"
            out[key] = np.ascontiguousarray(einops.rearrange(item[key], self.einops_order_audio))
        if self.einops_order_rgb:
            out["frames"] = np.ascontiguousarray(
                einops.rearrange(item["frames"], self.einops_order_rgb)
            )
        return out


class RGBToFloatToZeroOne:
    """uint8 [0, 255] -> float32 [0, 1] (reference RGBToFloatToZeroOne,
    data_transforms.py:689-696). DIVERGENCE (oracle-pinned): the reference divides by 255
    unconditionally — re-dividing already-[0,1] float frames into [0, 0.004]; this module's
    item convention is float frames in [0,1], so non-uint8 input passes through as a cast."""

    def __call__(self, item: dict) -> dict:
        out = dict(item)
        f = item["frames"]
        out["frames"] = f.astype(np.float32) / 255.0 if f.dtype == np.uint8 else f.astype(np.float32)
        return out


class RGBToHalfToZeroOne:
    """uint8 [0, 255] -> float16 [0, 1] (reference RGBToHalfToZeroOne,
    data_transforms.py:699-706)."""

    def __call__(self, item: dict) -> dict:
        out = dict(item)
        f = item["frames"]
        out["frames"] = f.astype(np.float16) / 255.0 if f.dtype == np.uint8 else f.astype(np.float16)
        return out


@dataclasses.dataclass
class EqualifyFromRight:
    """Trim audio/video to equal duration, dropping the longer tail from the right
    (reference EqualifyFromRight, data_transforms.py:20-57). Reference arithmetic exactly:
    the audio length derives from the VIDEO frame count via the floor-divided per-frame
    sample count (``a_fps // v_fps * int(v_fps * min_len)``), not from rounding the duration
    — at non-integral durations the two differ (oracle-pinned)."""

    clip_max_len_sec: float = 10.0

    def __call__(self, item: dict) -> dict:
        vfps = float(item.get("vfps", 25.0))
        afps = float(item.get("afps", 16000))
        v_dur = item["frames"].shape[0] / vfps
        a_dur = item["audio"].shape[-1] / afps
        min_len = min(self.clip_max_len_sec, a_dur, v_dur)
        a_frames_per_v_frame = afps // vfps
        v_len = int(vfps * min_len)
        a_len = int(a_frames_per_v_frame * v_len)
        out = dict(item)
        out["frames"] = item["frames"][:v_len]
        out["audio"] = item["audio"][..., :a_len]
        return out


@dataclasses.dataclass
class RandomApplyColorDistortion:
    """Color jitter + random grayscale, each gated by its own probability (reference
    RandomApplyColorDistortion, data_transforms.py:143-172)."""

    p_color_jitter: float = 0.8
    s: float = 1.0  # jitter strength
    p_gray: float = 0.2
    rng: Optional[np.random.Generator] = None

    def __call__(self, item: dict) -> dict:
        rng = self.rng or np.random.default_rng()
        out = dict(item)
        if rng.random() < self.p_color_jitter:
            out = ColorJitterFrames(
                brightness=0.8 * self.s, contrast=0.8 * self.s, saturation=0.8 * self.s, rng=rng
            )(out)
        if rng.random() < self.p_gray:
            gray = out["frames"].mean(axis=-1, keepdims=True)
            out = dict(out)
            out["frames"] = np.broadcast_to(gray, out["frames"].shape).copy()
        return out


@dataclasses.dataclass
class ApplyColorJitterFrameWise:
    """Independent jitter draw per frame instead of per clip (reference
    ApplyColorJitterFrameWise, data_transforms.py:175-200)."""

    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    rng: Optional[np.random.Generator] = None

    def __call__(self, item: dict) -> dict:
        rng = self.rng or np.random.default_rng()
        jitter = ColorJitterFrames(self.brightness, self.contrast, self.saturation, rng)
        frames = [
            jitter({"frames": f[None]})["frames"][0] for f in item["frames"]
        ]
        out = dict(item)
        out["frames"] = np.stack(frames)
        return out


@dataclasses.dataclass
class RGBSpatialCropSometimesUpscale:
    """With probability p, crop at a smaller size then upscale to the target; otherwise crop
    at the target size (reference RGBSpatialCropSometimesUpscale, data_transforms.py:112-140)."""

    sometimes_p: float = 0.5
    smaller_size: int = 192
    target_size: int = 224
    is_random: bool = True
    rng: Optional[np.random.Generator] = None
    device: DeviceLike = None

    def __call__(self, item: dict) -> dict:
        rng = self.rng or np.random.default_rng()
        if self.sometimes_p > 0 and rng.random() < self.sometimes_p:
            small = RandomResizedCropFrames(size=self.smaller_size, rng=rng,
                                            device=self.device)(item)
            out = dict(small)
            out["frames"] = _resize(small["frames"], self.target_size, self.target_size,
                                    pil_resize.BICUBIC, self.device)
            return out
        return RandomResizedCropFrames(size=self.target_size, rng=rng, device=self.device)(item)


@dataclasses.dataclass
class TemporalCropAndOffsetForSyncabilityTraining:
    """TemporalCropAndOffset variant that, with probability ``p_unsyncable``, draws an offset
    OUTSIDE the class grid and labels the pair unsyncable (reference
    TemporalCropAndOffsetForSyncabilityTraining, data_transforms.py:545-686)."""

    crop_len_s: float = 5.0
    vfps: float = 25.0
    afps: int = 16000
    p_unsyncable: float = 0.5
    max_off_s: float = 4.0
    rng: Optional[np.random.Generator] = None

    def __call__(self, item: dict) -> dict:
        rng = self.rng or np.random.default_rng()
        base = TemporalCropAndOffset(crop_len_s=self.crop_len_s, vfps=self.vfps,
                                     afps=self.afps, rng=rng)
        if item.get("offset_sec") is not None and item.get("v_start_i_sec") is not None:
            # Fixed-offset eval branch. DIVERGENCE: the reference's eval branch computes the
            # same crop but then CRASHES (data_transforms.py:675 reads `offset_is_syncable`,
            # assigned only in the train branch at :597 — UnboundLocalError, oracle-pinned);
            # we return the crop with the syncability label derived from grid membership.
            out = base._eval_crop(item, item["offset_sec"], item["v_start_i_sec"])
            # syncable iff the offset lies within the grid SPAN: train-time syncable draws
            # come from the grid itself, unsyncable ones from far outside (±crop_len), so a
            # near-edge out-of-span offset (e.g. 2.05 on a ±2 grid) must label unsyncable —
            # half-step proximity to the edge class would mislabel it
            grid_max = float(np.max(np.abs(base.grid)))
            in_span = abs(out["offset_sec"]) <= grid_max + 1e-6
            out["syncable_target"] = int(in_span)
            if not in_span:
                out["offset_target"] = -1
            return out
        grid_max = float(np.max(np.abs(base.grid)))
        out = base(item)
        if rng.random() < self.p_unsyncable:
            # re-shift audio by an offset beyond the grid: unsyncable
            extra = float(rng.uniform(grid_max + 0.25, self.max_off_s))
            sign = 1.0 if rng.random() < 0.5 else -1.0
            shift = int(round(sign * extra * self.afps))
            out["audio"] = np.roll(out["audio"], shift, axis=-1)
            out["syncable_target"] = 0
            out["offset_target"] = -1  # no valid grid class
        else:
            out["syncable_target"] = 1
        return out


class DoNothing:
    """Identity (reference DoNothing, data_transforms.py:1023-1028)."""

    def __call__(self, item: dict) -> dict:
        return item


def eval_transforms(crop_len_s: float = 5.0, size: int = 224,
                    device: DeviceLike = None) -> Compose:
    """Deterministic eval pipeline (reference eval transform stack); the mel on ``device``."""
    return Compose([
        GenerateMultipleSegments(),
        NormalizeFrames(),
        AudioMelSpectrogram(device),
    ])


def train_transforms(crop_len_s: float = 5.0, size: int = 224, seed: int = 0,
                     device: DeviceLike = None) -> Compose:
    """Training pipeline with the full reference augmentation set (vision jitter/crop/flip +
    audio volume/lowpass/pitch/reverb/noise; reference train transform stack); the resizes
    and the mel on ``device``."""
    rng = np.random.default_rng(seed)
    return Compose([
        EqualifyFromRight(),
        TemporalCropAndOffset(crop_len_s=crop_len_s, rng=rng),
        RGBSpatialCropSometimesUpscale(target_size=size, smaller_size=max(size * 6 // 7, 8),
                                       rng=rng, device=device),
        RandomApplyColorDistortion(rng=rng),
        RandomHorizontalFlipFrames(rng=rng),
        AudioRandomVolume(p=0.5, gain=2.0, rng=rng),
        AudioRandomLowpassFilter(p=0.2, cutoff_freq=3000.0, rng=rng),
        AudioRandomPitchShift(p=0.2, shift=400, rng=rng),
        AudioRandomReverb(p=0.2, rng=rng),
        AudioRandomGaussNoise(p=0.5, amplitude=0.01, rng=rng),
        GenerateMultipleSegments(),
        NormalizeFrames(),
        AudioMelSpectrogram(device),
    ])
