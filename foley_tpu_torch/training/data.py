"""Training data pipeline: WAV and AV datasets, latent shards, flow-matching batches and a
prefetching loader (``foley_tpu/training/data.py`` counterpart, its transforms suite aside).

- ``AudioFolderDataset`` / ``AVFolderDataset``: fixed-length random crops from a folder of
  WAV clips or of (PNG frames directory, WAV) pairs, drawn from a numpy generator exactly as
  the JAX package draws them (the same crops for the same seed).
- ``encode_corpus`` / ``encode_av_corpus``: the frozen encoders run once, on the device, and
  their outputs go to ``.npz`` shards (the JAX package's format: each package reads the
  other's shards); ``NpzShardDataset`` streams them back, ``latent_stats_from_shards`` gives
  the per-channel standardization of from-scratch training.
- ``flow_match_batches``: ``{latents, cond, clip_feat, sync_feat}`` numpy batches for
  ``training/train.py::flow_match_loss``, with the model's learned empty visual sequences for
  audio-only items and the CFG visual dropout drawn from numpy, as the JAX package draws it.
- ``PrefetchLoader``: a thread stages the next batches on the card while a step runs: each
  batch copied into page-locked host memory, then to the card on a side CUDA stream with an
  event recorded; the consumer's stream waits on that event before it uses the batch.

An item's encode draws its posterior noise from a generator seeded ``(seed, clip index)``
(``training/loop.py::step_generator``), the counterpart of the JAX package's
``fold_in(PRNGKey(seed), index)``.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from foley_tpu_torch.core.device import DeviceLike, resolve_device

logger = logging.getLogger("foley_tpu_torch")

_WAV_EXTS = (".wav", ".wave")


def list_audio_files(root: str) -> List[str]:
    """All WAV files under ``root``, sorted for a deterministic epoch order."""
    out: List[str] = []
    for dirpath, _, names in os.walk(root):
        out.extend(os.path.join(dirpath, n) for n in names if n.lower().endswith(_WAV_EXTS))
    return sorted(out)


class AudioFolderDataset:
    """Infinite sampler of fixed-length mono crops from a folder of WAV files.

    Yields ``{"audio": [T] fp32, "path": str}`` (plus whatever ``transforms`` adds). Short
    files are looped to ``clip_seconds``; rates are converted to ``sample_rate``."""

    def __init__(self, root: str, clip_seconds: float, sample_rate: int = 48000,
                 transforms: Optional[Callable[[dict], dict]] = None, seed: int = 0):
        self.files = list_audio_files(root)
        if not self.files:
            raise FileNotFoundError(f"no WAV files under {root}")
        self.clip_len = int(round(clip_seconds * sample_rate))
        self.sample_rate = sample_rate
        self.transforms = transforms
        self._rng = np.random.default_rng(seed)
        logger.info(f"AudioFolderDataset: {len(self.files)} files under {root}")

    def _crop(self, x: np.ndarray) -> np.ndarray:
        if len(x) < self.clip_len:
            x = np.tile(x, int(np.ceil(self.clip_len / max(len(x), 1))))
        start = int(self._rng.integers(0, len(x) - self.clip_len + 1))
        return x[start: start + self.clip_len]

    def __iter__(self) -> Iterator[dict]:
        from foley_tpu_torch.io.audio import read_wav

        while True:
            for i in self._rng.permutation(len(self.files)):
                path = self.files[int(i)]
                try:
                    x, _ = read_wav(path, target_sr=self.sample_rate)
                except (OSError, ValueError, RuntimeError) as e:  # corrupt file: skip it
                    logger.warning(f"skipping unreadable {path}: {e}")
                    continue
                item = {"audio": self._crop(x), "path": path}
                if self.transforms is not None:
                    item = self.transforms(item)
                yield item


def batch_items(items: Iterator[dict], batch_size: int, keys: Sequence[str]) -> Iterator[Dict]:
    """Stack ``batch_size`` consecutive items' ``keys`` into numpy batches."""
    buf: List[dict] = []
    for item in items:
        buf.append(item)
        if len(buf) == batch_size:
            yield {k: np.stack([b[k] for b in buf]) for k in keys}
            buf = []


class _ShardWriter:
    """Rows buffered into ``out_dir/shard_XXXXX.npz`` files of at least ``shard_size``."""

    def __init__(self, out_dir: str, shard_size: int):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir, self.shard_size = out_dir, shard_size
        self.shards: List[str] = []
        self.rows: Dict[str, List[np.ndarray]] = {}
        self.paths: List[str] = []

    def add(self, arrays: Dict[str, np.ndarray], paths: Sequence[str]) -> None:
        for k, v in arrays.items():
            self.rows.setdefault(k, []).append(v)
        self.paths.extend(paths)
        if len(self.paths) >= self.shard_size:
            self.flush()

    def flush(self) -> None:
        if not self.paths:
            return
        path = os.path.join(self.out_dir, f"shard_{len(self.shards):05d}.npz")
        np.savez(path, paths=np.asarray(self.paths),
                 **{k: np.concatenate(v) for k, v in self.rows.items()})
        self.shards.append(path)
        self.rows, self.paths = {}, []


def encode_corpus(dac, dataset: Iterator[dict], out_dir: str, num_clips: int,
                  batch_size: int = 8, shard_size: int = 256, seed: int = 0) -> List[str]:
    """DAC-encode ``num_clips`` audio items into ``.npz`` latent shards under ``out_dir``
    on the DAC's device (``dac``: the port's ``DAC``). Each batch's posterior sample draws
    from the generator of (seed, index of its first clip). Each shard holds ``latents``
    [N, T_lat, C_lat] fp32 and ``paths``. Returns the shard paths."""
    from foley_tpu_torch.models import dac_vae
    from foley_tpu_torch.training.loop import step_generator

    dev = next(dac.parameters()).device
    writer = _ShardWriter(out_dir, shard_size)
    it = iter(dataset)
    done = 0
    while done < num_clips:
        batch = [next(it) for _ in range(min(batch_size, num_clips - done))]
        audio = torch.from_numpy(np.stack([b["audio"] for b in batch])).to(dev)[..., None]
        z = dac_vae.encode(dac, audio).sample(step_generator(seed, done, dev))
        writer.add({"latents": z.float().cpu().numpy()}, [b.get("path", "") for b in batch])
        done += len(batch)
    writer.flush()
    logger.info(f"encoded {done} clips into {len(writer.shards)} shards under {out_dir}")
    return writer.shards


def list_av_clips(root: str) -> List[tuple]:
    """Paired (frames_dir, wav_path) clips under ``root``: a directory of image frames with
    its audio either inside it (a single .wav) or beside it as ``<dirname>.wav`` (the
    frames-directory convention of ``pipeline/video.py``)."""
    from foley_tpu_torch.pipeline.video import _IMAGE_EXTS

    pairs: List[tuple] = []
    for dirpath, dirnames, _ in os.walk(root):
        for d in sorted(dirnames):
            full = os.path.join(dirpath, d)
            names = os.listdir(full)
            if not any(n.lower().endswith(_IMAGE_EXTS) for n in names):
                continue
            inside = sorted(n for n in names if n.lower().endswith(_WAV_EXTS))
            sibling = full + ".wav"
            if inside:
                pairs.append((full, os.path.join(full, inside[0])))
            elif os.path.exists(sibling):
                pairs.append((full, sibling))
    return pairs


class AVFolderDataset:
    """Infinite sampler of synced fixed-length AV crops from paired frames-directory clips.

    Yields ``{"audio": [Ta] fp32, "frames": [Tv, H, W, 3] fp32 in [0, 1], "vfps", "afps",
    "path"}`` cut from one time window (one uniform start per draw). Short clips loop both
    streams to ``clip_seconds``. PNG frames are unfiltered on ``device`` (``cuda`` unless
    given; ``pipeline/video.py``)."""

    def __init__(self, root: str, clip_seconds: float, sample_rate: int = 48000,
                 frames_fps: float = 16.0, transforms: Optional[Callable[[dict], dict]] = None,
                 seed: int = 0, device: DeviceLike = None):
        self.clips = list_av_clips(root)
        if not self.clips:
            raise FileNotFoundError(f"no (frames dir, wav) clip pairs under {root}")
        self.clip_seconds = clip_seconds
        self.sample_rate = sample_rate
        self.frames_fps = frames_fps
        self.transforms = transforms
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        logger.info(f"AVFolderDataset: {len(self.clips)} clips under {root}")

    def __iter__(self) -> Iterator[dict]:
        from foley_tpu_torch.io.audio import read_wav
        from foley_tpu_torch.pipeline.video import read_video_frames

        n_a = int(round(self.clip_seconds * self.sample_rate))
        while True:
            for i in self._rng.permutation(len(self.clips)):
                frames_dir, wav_path = self.clips[int(i)]
                try:
                    audio, _ = read_wav(wav_path, target_sr=self.sample_rate)
                    frames, fps = read_video_frames(frames_dir, dir_fps=self.frames_fps,
                                                    device=self.device)
                except (OSError, ValueError, RuntimeError) as e:  # corrupt clip: skip it
                    logger.warning(f"skipping unreadable clip {frames_dir}: {e}")
                    continue
                n_v = int(round(self.clip_seconds * fps))
                if len(audio) < n_a:
                    audio = np.tile(audio, int(np.ceil(n_a / max(len(audio), 1))))
                if frames.shape[0] < n_v:
                    frames = np.tile(frames, (int(np.ceil(n_v / max(frames.shape[0], 1))),
                                              1, 1, 1))
                dur = min(len(audio) / self.sample_rate, frames.shape[0] / fps)
                start_s = float(self._rng.uniform(0.0, max(dur - self.clip_seconds, 0.0)))
                a0 = int(round(start_s * self.sample_rate))
                v0 = int(round(start_s * fps))
                item = {"audio": audio[a0: a0 + n_a], "frames": frames[v0: v0 + n_v],
                        "vfps": float(fps), "afps": self.sample_rate, "path": frames_dir}
                if self.transforms is not None:
                    item = self.transforms(item)
                yield item


def encode_av_corpus(dac, video_encoders: Dict, pipeline_cfg, dataset: Iterator[dict],
                     out_dir: str, num_clips: int, clip_seconds: float, shard_size: int = 64,
                     seed: int = 0) -> List[str]:
    """AV corpus encoding for V2A training: per clip, the DAC posterior latents and the
    SigLIP2 / Synchformer features (``pipeline/features.py::encode_video``, the sampler
    node's ``_encode_video``: the inference-time geometry) into ``.npz`` shards holding
    ``latents``, ``clip_feat``, ``sync_feat`` and ``paths``."""
    from foley_tpu_torch.api.nodes import HunyuanFoleySampler
    from foley_tpu_torch.models import dac_vae
    from foley_tpu_torch.training.loop import step_generator

    dev = next(dac.parameters()).device
    writer = _ShardWriter(out_dir, shard_size)
    it = iter(dataset)
    for done in range(num_clips):
        item = next(it)
        audio = torch.from_numpy(np.asarray(item["audio"], np.float32)).to(dev)[None, :, None]
        z = dac_vae.encode(dac, audio).sample(step_generator(seed, done, dev))
        clip_feat, sync_feat = HunyuanFoleySampler._encode_video(
            video_encoders, item["frames"], item["vfps"], clip_seconds, pipeline_cfg)
        writer.add({"latents": z.float().cpu().numpy(),
                    "clip_feat": clip_feat.float().cpu().numpy(),
                    "sync_feat": sync_feat.float().cpu().numpy()}, [item.get("path", "")])
    writer.flush()
    logger.info(f"encoded {num_clips} AV clips into {len(writer.shards)} shards under "
                f"{out_dir}")
    return writer.shards


class NpzShardDataset:
    """Infinite shuffled sampler over ``.npz`` shards (latents-only or latents + visual
    features; yields every per-row array but ``paths``)."""

    def __init__(self, shard_dir: str, seed: int = 0):
        self.shards = sorted(os.path.join(shard_dir, n) for n in os.listdir(shard_dir)
                             if n.endswith(".npz"))
        if not self.shards:
            raise FileNotFoundError(f"no .npz shards under {shard_dir}")
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[dict]:
        while True:
            for si in self._rng.permutation(len(self.shards)):
                with np.load(self.shards[int(si)]) as z:
                    arrays = {k: z[k] for k in z.files if k != "paths"}
                for ri in self._rng.permutation(arrays["latents"].shape[0]):
                    yield {k: v[int(ri)] for k, v in arrays.items()}


def latent_stats_from_shards(shard_dir: str) -> tuple:
    """Per-channel (mean, std) fp32 over every latent frame of a shard directory (streamed,
    Chan's parallel moments in fp64): what from-scratch training standardizes with, so the
    flow-matching targets sit at the unit noise's scale. Fine-tuning a pretrained model keeps
    the raw scale it learnt (no stats)."""
    count, mean, m2 = 0, None, None
    for path in sorted(os.path.join(shard_dir, n) for n in os.listdir(shard_dir)
                       if n.endswith(".npz")):
        with np.load(path) as z:
            lat = z["latents"].astype(np.float64)  # [N, T, C]
        flat = lat.reshape(-1, lat.shape[-1])
        if mean is None:
            mean, m2 = np.zeros(flat.shape[-1]), np.zeros(flat.shape[-1])
        n_new = flat.shape[0]
        delta = flat.mean(0) - mean
        mean += delta * n_new / (count + n_new)
        m2 += flat.var(0) * n_new + delta ** 2 * count * n_new / (count + n_new)
        count += n_new
    if mean is None:
        raise FileNotFoundError(f"no .npz shards under {shard_dir}")
    std = np.sqrt(m2 / count)
    return mean.astype(np.float32), np.maximum(std, 1e-6).astype(np.float32)


def flow_match_batches(latent_iter: Iterator[dict], model, pipeline_cfg, batch_size: int,
                       text_bucket: int = 77,
                       cond_fn: Optional[Callable[[Dict[str, np.ndarray]], np.ndarray]] = None,
                       latent_stats: Optional[tuple] = None, drop_visual_p: float = 0.0,
                       drop_rng: Optional[np.random.Generator] = None
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """``{latents, cond, clip_feat, sync_feat}`` numpy fp32 batches for ``flow_match_loss``.

    Items with ``clip_feat`` / ``sync_feat`` (``encode_av_corpus`` shards) bring their visual
    features; audio-only items condition on ``model``'s learned empty clip / sync sequences
    at the sampler's T2A lengths. ``cond_fn(batch) -> [B, L, condition_dim]`` supplies text
    features (zeros, the uncond text branch, otherwise). ``drop_visual_p`` replaces a row's
    visual features with the empty sequences at that probability (CFG dropout, drawn from
    ``drop_rng``). ``latent_stats=(mean, std)`` standardizes the latents per channel."""
    from foley_tpu_torch.models import mmdit

    # an iterator once: a re-iterable would restart, duplicating the probe item
    latent_iter = iter(latent_iter)
    probe = next(latent_iter)
    lat_len = probe["latents"].shape[0]
    has_visual = "clip_feat" in probe and "sync_feat" in probe
    if has_visual:
        clip_len, sync_len = probe["clip_feat"].shape[0], probe["sync_feat"].shape[0]
    else:
        duration_s = lat_len / pipeline_cfg.model.audio_frame_rate
        clip_len, sync_len = pipeline_cfg.t2a_lengths(duration_s)
    with torch.no_grad():
        empty_clip, empty_sync = (
            seq.float().contiguous().cpu().numpy() for seq in (
                mmdit.get_empty_clip_sequence(model, batch_size, clip_len),
                mmdit.get_empty_sync_sequence(model, batch_size, sync_len)))
    drop_rng = drop_rng or np.random.default_rng()

    def items():
        yield probe
        yield from latent_iter

    keys = ("latents", "clip_feat", "sync_feat") if has_visual else ("latents",)
    for batch in batch_items(items(), batch_size, keys=keys):
        cond = (cond_fn(batch) if cond_fn is not None else np.zeros(
            (batch_size, text_bucket, pipeline_cfg.model.condition_dim), np.float32))
        lat = batch["latents"].astype(np.float32)
        if latent_stats is not None:
            mean, std = latent_stats
            lat = (lat - mean) / std
        if has_visual:
            clip_feat = batch["clip_feat"].astype(np.float32)
            sync_feat = batch["sync_feat"].astype(np.float32)
            if drop_visual_p > 0.0:
                drop = drop_rng.random(batch_size) < drop_visual_p
                clip_feat = np.where(drop[:, None, None], empty_clip, clip_feat)
                sync_feat = np.where(drop[:, None, None], empty_sync, sync_feat)
        else:
            clip_feat, sync_feat = empty_clip, empty_sync
        yield {"latents": lat, "cond": cond, "clip_feat": clip_feat, "sync_feat": sync_feat}


_SENTINEL = object()


class _LoaderError:
    def __init__(self, error: BaseException):
        self.error = error


class PrefetchLoader:
    """Stage upcoming batches on ``device`` (``cuda`` unless given) from a background thread,
    up to ``depth`` ahead, so host work and copies overlap the running step.

    On the card each batch's arrays go into page-locked host memory, then to the card on a
    side stream (``non_blocking``), and an event is recorded after the copies; ``__next__``
    makes the consumer's current stream wait on that event, and records the batch's tensors
    as used by that stream, so the caching allocator keeps them until the consumer is done.
    On the CPU a batch becomes tensors in place. Iteration ends with the source; an error of
    the source is raised by ``__next__``; ``close()`` stops the thread early."""

    def __init__(self, batches: Iterator[Dict], depth: int = 2, device: DeviceLike = None):
        self._src = batches
        self._device = resolve_device(device)
        cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if cuda else None
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _stage(self, batch: Dict) -> tuple:
        tensors = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
        if self._stream is None:
            return tensors, None
        with torch.cuda.stream(self._stream):
            staged = {k: t.pin_memory().to(self._device, non_blocking=True)
                      for k, t in tensors.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        try:
            for batch in self._src:
                if self._stop.is_set() or not self._put(self._stage(batch)):
                    return
            self._put(_SENTINEL)
        except Exception as e:  # noqa: BLE001 - a loader error surfaces on the consumer side
            self._put(_LoaderError(e))

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if item is _SENTINEL:
            raise StopIteration
        if isinstance(item, _LoaderError):
            raise item.error
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in batch.values():
                t.record_stream(consumer)
        return batch

    def close(self) -> None:
        self._stop.set()
