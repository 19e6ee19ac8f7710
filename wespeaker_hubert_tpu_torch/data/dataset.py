"""Host-side input for extraction: data lists and bucketed eval batches.

Counterpart of the extraction pieces of `wespeaker_hubert_tpu/data/
dataset.py`: `load_data_list`, `iter_raw_list` (JSONL {key, wav}),
`iter_feat_list` (JSONL {key, feat} with Kaldi matrix rxspecifiers),
`chunk_samples_for_frames` and `EvalPipeline`.  The `shard` data type (tar
archives) is not ported yet.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, Iterable, Iterator, List, Sequence

import numpy as np

from .wav_io import read_wav

__all__ = [
    "chunk_samples_for_frames",
    "load_data_list",
    "iter_raw_list",
    "iter_feat_list",
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
        if data_type not in ("raw", "feat"):
            raise NotImplementedError(
                f"data_type {data_type!r} is not ported yet (raw and feat are)"
            )
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
