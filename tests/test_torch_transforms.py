"""The port's AV transform suite (``pipeline/transforms.py``) against
``foley_tpu.pipeline.transforms``, and its parity metrics (``utils/metrics.py``) against
``foley_tpu.utils.metrics``, on the CPU.

Every class of the suite and both compositions run on the same items (numpy, from seeds)
with generators of the same seed on the two sides: every output equal bit for bit (the
same numpy code and draws; the frame resizes through ``ops/pil_resize.py`` equal to PIL's),
except the mel features (``a_spec``), held within atol 2e-4 (torch's FFT and XLA's differ
in the last places; the normalised log-mel's own tolerance in ``test_torch_desync.py``).
The metrics: the same float64 numpy, equal.
"""

import copy

import numpy as np
import pytest

from foley_tpu.pipeline import transforms as J
from foley_tpu.utils import metrics as jmetrics
from foley_tpu_torch.pipeline import transforms as T
from foley_tpu_torch.utils import metrics as tmetrics
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

SPEC_ATOL = 2e-4
CPU = dict(device="cpu")


def _clip(seconds=2.0, hw=(32, 48), audio_seconds=None, seed=0, uint8=False):
    rng = np.random.default_rng(seed)
    frames = rng.random((int(25 * seconds), *hw, 3)).astype(np.float32)
    if uint8:
        frames = (frames * 255).astype(np.uint8)
    n_audio = int(16000 * (audio_seconds or seconds))
    return {"frames": frames, "audio": (rng.random(n_audio).astype(np.float32) - 0.5) * 0.2}


def _spec_item(t=50, seed=1):
    rng = np.random.default_rng(seed)
    return {"a_spec": rng.random((3, 128, t)).astype(np.float32) + 0.01}


def _rng(seed):
    return np.random.default_rng(seed)


# name -> (build(module, dev), item)
CASES = {
    "compose": (lambda M, d: M.Compose([M.NormalizeFrames(), M.DoNothing()]), _clip()),
    "temporal_crop": (lambda M, d: M.TemporalCropAndOffset(crop_len_s=1.0, rng=_rng(1)),
                      _clip()),
    "temporal_crop_eval": (lambda M, d: M.TemporalCropAndOffset(crop_len_s=1.0, rng=_rng(1)),
                           dict(_clip(), offset_sec=0.43, v_start_i_sec=0.2)),
    "segments": (lambda M, d: M.GenerateMultipleSegments(), _clip()),
    "segments_random_jitter": (lambda M, d: M.GenerateMultipleSegments(
        is_start_random=True, audio_jitter_sec=0.05, rng=_rng(2)), _clip()),
    "segments_step_size": (lambda M, d: M.GenerateMultipleSegments(step_size_seg=0.5,
                                                                   n_segments=3), _clip()),
    "letterbox": (lambda M, d: M.ResizeAndLetterbox(size=64, **d), _clip()),
    "letterbox_tall": (lambda M, d: M.ResizeAndLetterbox(size=20, **d), _clip(hw=(45, 17))),
    "random_resized_crop": (lambda M, d: M.RandomResizedCropFrames(size=40, rng=_rng(3), **d),
                            _clip()),
    "color_jitter": (lambda M, d: M.ColorJitterFrames(rng=_rng(4)), _clip()),
    "hflip": (lambda M, d: M.RandomHorizontalFlipFrames(p=1.0, rng=_rng(5)), _clip()),
    "normalize": (lambda M, d: M.NormalizeFrames(), _clip()),
    "random_gain": (lambda M, d: M.RandomAudioGain(rng=_rng(6)), _clip()),
    "gaussian_noise": (lambda M, d: M.AddGaussianNoise(rng=_rng(7)), _clip()),
    "mel": (lambda M, d: M.AudioMelSpectrogram(**d), _clip()),
    "volume_db": (lambda M, d: M.AudioRandomVolume(p=1.0, gain=3.0, gain_type="db",
                                                   rng=_rng(8)), _clip()),
    "volume_power": (lambda M, d: M.AudioRandomVolume(p=1.0, gain_type="power", rng=_rng(8)),
                     _clip()),
    "lowpass": (lambda M, d: M.AudioRandomLowpassFilter(p=1.0, rng=_rng(9)), _clip()),
    "pitch_shift": (lambda M, d: M.AudioRandomPitchShift(p=1.0, rng=_rng(10)), _clip()),
    "reverb": (lambda M, d: M.AudioRandomReverb(p=1.0, rng=_rng(11)), _clip()),
    "gauss_noise": (lambda M, d: M.AudioRandomGaussNoise(p=1.0, rng=_rng(12)), _clip()),
    "audio_log": (lambda M, d: M.AudioLog(), _spec_item()),
    "pad": (lambda M, d: M.PadOrTruncate(max_spec_t=66), _spec_item(50)),
    "truncate": (lambda M, d: M.PadOrTruncate(max_spec_t=66), _spec_item(80)),
    "normalize_ast": (lambda M, d: M.AudioNormalizeAST(), _spec_item()),
    "resample_audio": (lambda M, d: M.ResampleAudio(new_fps=22050), dict(_clip(), afps=16000)),
    "resample_rgb": (lambda M, d: M.ResampleRGB(new_fps=16.0), dict(_clip(), vfps=25.0)),
    "letterbox_pad": (lambda M, d: M.ResizeAndLetterboxPad(new_h=40, new_w=30, **d), _clip()),
    "resample_resize_letterbox_pad": (lambda M, d: M.ResampleResizeLetterboxPad(
        afps=22050, vfps=10.0, new_h=36, new_w=36, **d), dict(_clip(), afps=16000, vfps=25.0)),
    "permute": (lambda M, d: M.PermuteStreams(einops_order_audio="s f t -> s t f",
                                              einops_order_rgb="t h w c -> t c h w"),
                dict(_clip(), **_spec_item())),
    "rgb_float": (lambda M, d: M.RGBToFloatToZeroOne(), _clip(uint8=True)),
    "rgb_half": (lambda M, d: M.RGBToHalfToZeroOne(), _clip(uint8=True)),
    "equalify": (lambda M, d: M.EqualifyFromRight(clip_max_len_sec=1.5), _clip()),
    "color_distortion": (lambda M, d: M.RandomApplyColorDistortion(p_gray=0.5, rng=_rng(13)),
                         _clip()),
    "color_distortion_gray": (lambda M, d: M.RandomApplyColorDistortion(
        p_color_jitter=0.0, p_gray=1.0, rng=_rng(13)), _clip()),
    "framewise_jitter": (lambda M, d: M.ApplyColorJitterFrameWise(rng=_rng(14)), _clip()),
    "crop_upscale": (lambda M, d: M.RGBSpatialCropSometimesUpscale(
        sometimes_p=1.0, smaller_size=24, target_size=32, rng=_rng(15), **d), _clip()),
    "crop_no_upscale": (lambda M, d: M.RGBSpatialCropSometimesUpscale(
        sometimes_p=0.0, target_size=32, rng=_rng(15), **d), _clip()),
    "syncability_train": (lambda M, d: M.TemporalCropAndOffsetForSyncabilityTraining(
        crop_len_s=1.0, rng=_rng(16)), _clip()),
    "syncability_eval_in_span": (lambda M, d: M.TemporalCropAndOffsetForSyncabilityTraining(
        crop_len_s=1.0, rng=_rng(17)), dict(_clip(), offset_sec=0.5, v_start_i_sec=0.2)),
    "syncability_eval_out_of_span": (
        lambda M, d: M.TemporalCropAndOffsetForSyncabilityTraining(crop_len_s=1.0,
                                                                   rng=_rng(17)),
        dict(_clip(audio_seconds=5.0), offset_sec=2.4, v_start_i_sec=0.0)),
    "do_nothing": (lambda M, d: M.DoNothing(), _clip()),
}


def _assert_items_equal(got, ref):
    assert set(got) == set(ref)
    for key, r in ref.items():
        g = got[key]
        if isinstance(r, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == r.dtype and g.shape == r.shape, key
            if key == "a_spec":
                np.testing.assert_allclose(g, r, rtol=0, atol=SPEC_ATOL, err_msg=key)
            else:
                np.testing.assert_array_equal(g, r, err_msg=key)
        else:
            assert type(g) is type(r) and g == r, (key, g, r)


def test_every_class_has_a_case():
    names = {n for n, v in vars(J).items() if isinstance(v, type) and v.__module__ == J.__name__}
    built = {type(build(J, {})).__name__ for build, _ in CASES.values()}
    built |= {"DoNothing", "NormalizeFrames"}  # inside the compose case
    assert names == built, names ^ built
    assert len(names) == 32
    assert names <= {n for n, v in vars(T).items() if isinstance(v, type)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_matches_jax(name):
    build, item = CASES[name]
    ref = build(J, {})(copy.deepcopy(item))
    got = build(T, CPU)(copy.deepcopy(item))
    _assert_items_equal(got, ref)


def test_syncability_draws_both_labels_as_jax():
    """Eight items through one syncability transform each side: the same sequence of
    syncable and unsyncable draws (both occur), item for item."""
    j_t = J.TemporalCropAndOffsetForSyncabilityTraining(crop_len_s=1.0, rng=_rng(18))
    t_t = T.TemporalCropAndOffsetForSyncabilityTraining(crop_len_s=1.0, rng=_rng(18))
    labels = []
    for seed in range(8):
        item = _clip(seed=seed)
        ref, got = j_t(copy.deepcopy(item)), t_t(copy.deepcopy(item))
        _assert_items_equal(got, ref)
        labels.append(ref["syncable_target"])
    assert set(labels) == {0, 1}


def test_eval_transforms_match_jax():
    item = _clip(seconds=5.0, hw=(36, 64))
    ref = J.eval_transforms()(copy.deepcopy(item))
    got = T.eval_transforms(**CPU)(copy.deepcopy(item))
    assert got["a_spec"].shape == (14, 128, 66)
    _assert_items_equal(got, ref)


def test_train_transforms_match_jax():
    """Three items through one pipeline each side (the generator's state carries over)."""
    j_pipe = J.train_transforms(crop_len_s=5.0, size=32, seed=3)
    t_pipe = T.train_transforms(crop_len_s=5.0, size=32, seed=3, **CPU)
    for seed in range(3):
        item = _clip(seconds=6.0, hw=(36, 64), seed=seed)
        ref, got = j_pipe(copy.deepcopy(item)), t_pipe(copy.deepcopy(item))
        assert got["v_segments"].shape[2:] == (32, 32, 3)
        _assert_items_equal(got, ref)


# ---------------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (512, 128)])
def test_metrics_equal_jax(n_fft, hop):
    rng = np.random.default_rng(20)
    x = rng.normal(size=9000).astype(np.float32)
    y = x + 0.3 * rng.normal(size=9100).astype(np.float32)[:9000]
    assert (tmetrics.spectral_correlation(x, y, n_fft, hop)
            == jmetrics.spectral_correlation(x, y, n_fft, hop))
    assert tmetrics.spectral_correlation(x, x, n_fft, hop) == pytest.approx(1.0)
    assert tmetrics.snr_db(y, x) == jmetrics.snr_db(y, x)
