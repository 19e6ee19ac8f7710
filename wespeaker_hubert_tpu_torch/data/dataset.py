"""Host-side input: data lists, the training pipeline and bucketed eval
batches.

Counterpart of `wespeaker_hubert_tpu/data/dataset.py`: `load_data_list`,
`iter_raw_list` (JSONL {key, wav, spk}), `iter_feat_list` (JSONL {key,
feat, spk} with Kaldi matrix rxspecifiers), `chunk_samples_for_frames`,
`shard_list_for_rank`, `buffer_shuffle`, `TrainPipelineConfig`,
`TrainPipeline` and `EvalPipeline`.  The host decodes and selects (list
striping, shuffle, chunk choice, augmentation parameters) and ships
fixed-shape numpy batches; the DSP runs on the device (ops/augment.py).
`TrainPipeline` makes the same `random.Random` and `np.random.default_rng`
draws in the same order as the JAX package's, so its batches are identical
for the same list, seed and stores.  The `shard` data type (tar archives)
is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import random
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from ..ops.augment import speed_input_len
from .aug_store import AugStore, snr_range_for_key
from .wav_io import read_wav

__all__ = [
    "chunk_samples_for_frames",
    "load_data_list",
    "iter_raw_list",
    "iter_feat_list",
    "shard_list_for_rank",
    "buffer_shuffle",
    "TrainPipelineConfig",
    "TrainPipeline",
    "EvalPipeline",
]

logger = logging.getLogger(__name__)


def chunk_samples_for_frames(
    num_frms: int, frame_shift_ms: float = 10.0, frame_length_ms: float = 25.0,
    sample_rate: int = 16000,
) -> int:
    """Samples required for exactly num_frms fbank frames."""
    return int(
        ((num_frms - 1) * frame_shift_ms + frame_length_ms) * sample_rate / 1000
    )


def load_data_list(path: str) -> List[str]:
    """A data-list file -> its non-empty lines."""
    with open(path, "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def iter_raw_list(entries: Iterable[str]) -> Iterator[dict]:
    """JSON entry lines -> {key, wav (float32), sample_rate, spk}; an entry
    that fails to read is logged and skipped."""
    for line in entries:
        try:
            obj = json.loads(line)
            wav, sr = read_wav(obj["wav"])
            if "vad" in obj:
                parts = [
                    wav[int(float(s) * sr) : int(float(e) * sr)]
                    for s, e in obj["vad"]
                ]
                wav = np.concatenate(parts) if parts else wav[:0]
            yield {
                "key": obj["key"],
                "spk": obj.get("spk", ""),
                "wav": wav,
                "sample_rate": sr,
            }
        except Exception as e:  # corrupt sample: warn + skip
            logger.warning("failed to read sample: %s", e)


def iter_feat_list(entries: Iterable[str]) -> Iterator[dict]:
    """JSON entry lines {key, feat, spk} -> {key, feat (T, F float32), spk};
    'feat' is a Kaldi matrix-ark rxspecifier 'file.ark:offset'."""
    from ..backend.kaldi_io import read_kaldi_matrix

    for line in entries:
        try:
            obj = json.loads(line)
            feat = np.asarray(read_kaldi_matrix(obj["feat"]), np.float32)
            yield {"key": obj["key"], "spk": obj.get("spk", ""), "feat": feat}
        except Exception as e:  # corrupt sample: warn + skip
            logger.warning("failed to read feat sample: %s", e)


def _refuse_shard(data_type: str) -> None:
    if data_type not in ("raw", "feat"):
        raise NotImplementedError(
            f"data_type {data_type!r} is not ported yet (raw and feat are)"
        )


def shard_list_for_rank(
    entries: Sequence[str],
    epoch: int,
    rank: int = 0,
    world_size: int = 1,
    worker: int = 0,
    num_workers: int = 1,
    shuffle: bool = True,
    seed: int = 42,
) -> List[str]:
    """The epoch's list for one rank and worker: an epoch-seeded shuffle,
    then `[rank::world_size][worker::num_workers]`."""
    data = list(entries)
    if shuffle:
        rng = random.Random(seed + epoch)
        rng.shuffle(data)
    return data[rank::world_size][worker::num_workers]


def buffer_shuffle(it: Iterator, buffer_size: int, rng: random.Random) -> Iterator:
    """Streaming shuffle with a bounded buffer."""
    buf = []
    for x in it:
        buf.append(x)
        if len(buf) >= buffer_size:
            idx = rng.randrange(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def _random_chunk(x: np.ndarray, chunk_len: int, rng: random.Random) -> np.ndarray:
    """A random crop, or a tiled pad when short; samples (1-D) or frames
    (2-D, axis 0)."""
    n = len(x)
    if n >= chunk_len:
        start = rng.randint(0, n - chunk_len)
        return x[start : start + chunk_len]
    reps = chunk_len // max(n, 1) + 1
    return np.tile(x, (reps,) + (1,) * (x.ndim - 1))[:chunk_len]


@dataclasses.dataclass
class TrainPipelineConfig:
    data_type: str = "raw"  # 'raw' | 'feat' ('shard' is not ported yet)
    num_frms: int = 200
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    sample_rate: int = 16000
    shuffle: bool = True
    shuffle_size: int = 2500
    filter_min_frames: int = 100
    filter_max_frames: int = 800
    speed_perturb: bool = True
    aug_prob: float = 0.6
    rir_max_samples: int = 8000
    batch_size: int = 64
    drop_last: bool = True
    seed: int = 42
    # packed layout: each batch sorted into fixed-count slots [reverb |
    # noise | clean], so the device FFT-convolves only the reverb rows;
    # counts rounded to multiples of aug_align
    packed_aug: bool = True
    aug_align: int = 1


class TrainPipeline:
    """Data list -> device-ready numpy training batches.

    Batch fields: wav (B, L_in) float32 (L_in = speed_input_len(chunk) with
    speed perturbation, else the chunk), speed_idx (B,) int32 (with speed
    perturbation), label (B,) int32 (x3-expanded with speed perturbation);
    unpacked: aug_type (B,) int32 (0 none, 1 reverb, 2 noise), rir (B, R),
    noise (B, chunk), snr (B,); packed: rir (n_reverb, R), noise
    (n_noise, chunk), snr (n_noise,), rows ordered [reverb | noise | clean].
    `data_type='feat'` batches carry feat (B, num_frms, F) and label.
    """

    def __init__(
        self,
        data_list: Sequence[str],
        spk2id: Dict[str, int],
        cfg: TrainPipelineConfig = TrainPipelineConfig(),
        reverb_store: Optional[AugStore] = None,
        noise_store: Optional[AugStore] = None,
        rank: int = 0,
        world_size: int = 1,
        worker: int = 0,
        num_workers: int = 1,
    ):
        _refuse_shard(cfg.data_type)
        self.data_list = list(data_list)
        self.spk2id = spk2id
        self.cfg = cfg
        self.reverb_store = reverb_store
        self.noise_store = noise_store
        self.rank = rank
        self.world_size = world_size
        self.worker = worker
        self.num_workers = max(1, num_workers)
        self.epoch = 0
        self.chunk_samples = chunk_samples_for_frames(
            cfg.num_frms, cfg.frame_shift_ms, cfg.frame_length_ms, cfg.sample_rate
        )
        self.input_samples = (
            speed_input_len(self.chunk_samples) if cfg.speed_perturb else self.chunk_samples
        )
        self.aug_counts = self._compute_aug_counts()

    def _compute_aug_counts(self):
        """(n_reverb, n_noise) per batch for the packed layout: the expected
        shares of per-sample Bernoulli(aug_prob) draws split 50/50, a missing
        store's share falling through as in the unpacked path."""
        cfg = self.cfg
        if cfg.data_type == "feat" or not cfg.packed_aug:
            return (0, 0)
        a = max(1, cfg.aug_align)

        def rnd(x):
            return max(0, int(round(x / a)) * a)

        b, p = cfg.batch_size, cfg.aug_prob
        if self.reverb_store and self.noise_store:
            return (rnd(b * p / 2), rnd(b * p / 2))
        if self.noise_store:  # reverb draws fall through to noise
            return (0, rnd(b * p))
        if self.reverb_store:  # noise draws are dropped
            return (rnd(b * p / 2), 0)
        return (0, 0)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _samples(self) -> Iterator[dict]:
        cfg = self.cfg
        entries = shard_list_for_rank(
            self.data_list, self.epoch, self.rank, self.world_size,
            worker=self.worker, num_workers=self.num_workers,
            shuffle=cfg.shuffle, seed=cfg.seed,
        )
        it = (iter_feat_list if cfg.data_type == "feat" else iter_raw_list)(entries)
        rng = random.Random(cfg.seed + 77 * self.epoch + self.rank + 10007 * self.worker)
        if cfg.shuffle:
            it = buffer_shuffle(it, cfg.shuffle_size, rng)

        if cfg.data_type == "feat":
            for s in it:
                feat = s["feat"]
                if not cfg.filter_min_frames <= len(feat) <= cfg.filter_max_frames:
                    continue
                if s["spk"] not in self.spk2id:
                    continue
                yield {
                    "feat": _random_chunk(feat, cfg.num_frms, rng).astype(np.float32),
                    "label": np.int32(self.spk2id[s["spk"]]),
                }
            return

        min_samp = int(cfg.filter_min_frames * cfg.frame_shift_ms / 1000 * cfg.sample_rate)
        max_samp = int(cfg.filter_max_frames * cfg.frame_shift_ms / 1000 * cfg.sample_rate)
        nprng = np.random.default_rng(
            cfg.seed + 1000 * self.epoch + self.rank + 10007 * self.worker
        )
        n_rev, n_noise = self.aug_counts
        pos = 0  # slot within the current batch (packed layout)
        for s in it:
            wav = s["wav"]
            if not min_samp <= len(wav) <= max_samp:
                continue
            spk = s["spk"]
            if spk not in self.spk2id:
                continue
            label = self.spk2id[spk]
            speed_idx = 0
            if cfg.speed_perturb:
                speed_idx = rng.randint(0, 2)
                label = label + len(self.spk2id) * speed_idx  # x3 label space
            chunk = _random_chunk(wav, self.input_samples, rng)
            sample = {"wav": chunk.astype(np.float32), "label": np.int32(label)}
            if cfg.speed_perturb:
                sample["speed_idx"] = np.int32(speed_idx)
            if cfg.packed_aug:
                # the slot decides the augmentation; parameters drawn only
                # where needed
                if pos < n_rev:
                    _, r = self.reverb_store.random_one(nprng)
                    r = np.asarray(r, np.float32)[: cfg.rir_max_samples]
                    rir = np.zeros((cfg.rir_max_samples,), np.float32)
                    rir[: len(r)] = r
                    sample["rir"] = rir
                elif pos < n_rev + n_noise:
                    key, nz = self.noise_store.random_one(nprng)
                    sample["noise"] = _random_chunk(
                        np.asarray(nz, np.float32), self.chunk_samples, rng
                    ).astype(np.float32)
                    lo, hi = snr_range_for_key(key)
                    sample["snr"] = np.float32(rng.uniform(lo, hi))
            else:
                aug_type, snr = 0, 0.0
                rir = np.zeros((cfg.rir_max_samples,), np.float32)
                noise = np.zeros((self.chunk_samples,), np.float32)
                if cfg.aug_prob > rng.random() and (self.reverb_store or self.noise_store):
                    aug_type = rng.randint(1, 2)
                    if aug_type == 1 and self.reverb_store is not None:
                        _, r = self.reverb_store.random_one(nprng)
                        r = np.asarray(r, np.float32)[: cfg.rir_max_samples]
                        rir[: len(r)] = r
                    elif self.noise_store is not None:
                        aug_type = 2
                        key, nz = self.noise_store.random_one(nprng)
                        noise = _random_chunk(np.asarray(nz, np.float32), self.chunk_samples, rng)
                        lo, hi = snr_range_for_key(key)
                        snr = rng.uniform(lo, hi)
                    else:
                        aug_type = 0
                sample.update(
                    aug_type=np.int32(aug_type),
                    rir=rir,
                    noise=noise.astype(np.float32),
                    snr=np.float32(snr),
                )
            yield sample
            pos = (pos + 1) % cfg.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        buf: List[dict] = []
        for s in self._samples():
            buf.append(s)
            if len(buf) == self.cfg.batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self.cfg.drop_last:
            yield self._collate(buf)

    def _collate(self, samples: List[dict]) -> Dict[str, np.ndarray]:
        if not self.cfg.packed_aug:
            return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        n_rev, n_noise = self.aug_counts
        n = len(samples)
        n_rev = min(n_rev, n)
        n_noise = min(n_noise, max(0, n - n_rev))
        batch = {
            k: np.stack([s[k] for s in samples])
            for k in ("wav", "feat", "speed_idx", "label")
            if k in samples[0]
        }
        if n_rev or n_noise:
            batch["rir"] = (
                np.stack([s["rir"] for s in samples[:n_rev]]) if n_rev
                else np.zeros((0, self.cfg.rir_max_samples), np.float32)
            )
            noise_rows = samples[n_rev : n_rev + n_noise]
            batch["noise"] = (
                np.stack([s["noise"] for s in noise_rows]) if n_noise
                else np.zeros((0, self.chunk_samples), np.float32)
            )
            batch["snr"] = np.asarray([s["snr"] for s in noise_rows], np.float32)
        return batch


class EvalPipeline:
    """Whole-utterance extraction batches with length bucketing.

    Utterances are padded to a small set of lengths (powers-of-two frames)
    and their lengths travel with them, so masks keep results exact.
    Utterances longer than the largest base bucket are not cropped: the
    bucket set extends by doubling up to `max_bucket_frames`, with the
    bucket's batch size shrunk so batch x length stays bounded; only past
    `max_bucket_frames` is audio cropped, with a warning.
    """

    def __init__(
        self,
        data_list: Sequence[str],
        data_type: str = "raw",
        batch_size: int = 32,
        bucket_frames: Sequence[int] = (200, 400, 800, 1600, 3200),
        frame_shift_ms: float = 10.0,
        frame_length_ms: float = 25.0,
        sample_rate: int = 16000,
        extend_buckets: bool = True,
        max_bucket_frames: int = 51200,
    ):
        _refuse_shard(data_type)
        self.data_list = list(data_list)
        self.data_type = data_type
        self.batch_size = batch_size
        if data_type == "feat":
            # precomputed features: bucket units are frames
            self.bucket_samples = list(bucket_frames)
            self.max_bucket_samples = max_bucket_frames
        else:
            self.bucket_samples = [
                chunk_samples_for_frames(b, frame_shift_ms, frame_length_ms, sample_rate)
                for b in bucket_frames
            ]
            self.max_bucket_samples = chunk_samples_for_frames(
                max_bucket_frames, frame_shift_ms, frame_length_ms, sample_rate
            )
        self.extend_buckets = extend_buckets

    def _bucket_for(self, n: int) -> int:
        for b in self.bucket_samples:
            if n <= b:
                return b
        b = self.bucket_samples[-1]
        if not self.extend_buckets:
            return b
        while n > b and b < self.max_bucket_samples:
            b = min(b * 2, self.max_bucket_samples)
        return b

    def _batch_for(self, bucket: int) -> int:
        """Shrink the batch for extended buckets so batch x samples stays
        bounded by batch_size x the largest base bucket."""
        base = self.bucket_samples[-1]
        if bucket <= base:
            return self.batch_size
        return max(1, self.batch_size * base // bucket)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        is_feat = self.data_type == "feat"
        it = (iter_feat_list if is_feat else iter_raw_list)(self.data_list)
        buckets: Dict[int, List[dict]] = {}
        for s in it:
            x = s["feat"] if is_feat else s["wav"]
            b = self._bucket_for(len(x))
            if len(x) > b:  # only past max_bucket_samples
                logger.warning(
                    "cropping %s from %d to %d %s (max_bucket_frames)",
                    s["key"], len(x), b, "frames" if is_feat else "samples",
                )
                x = x[:b]
            buckets.setdefault(b, []).append({"key": s["key"], "x": x, "length": len(x)})
            if len(buckets[b]) >= self._batch_for(b):
                yield self._collate(buckets.pop(b), b)
        for b, samples in buckets.items():
            if samples:
                yield self._collate(samples, b)

    def _collate(self, samples: List[dict], bucket: int) -> Dict[str, np.ndarray]:
        n = len(samples)
        lengths = np.asarray([s["length"] for s in samples], np.int32)
        keys = [s["key"] for s in samples]
        if self.data_type == "feat":
            feat = np.zeros((n, bucket, samples[0]["x"].shape[1]), np.float32)
            for i, s in enumerate(samples):
                feat[i, : s["length"]] = s["x"]
            return {"feat": feat, "feat_length": lengths, "keys": keys}
        wav = np.zeros((n, bucket), np.float32)
        for i, s in enumerate(samples):
            wav[i, : s["length"]] = s["x"]
        return {"wav": wav, "length": lengths, "keys": keys}
