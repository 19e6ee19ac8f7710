"""Multi-crop host pipeline for self-supervised training.

Counterpart of `wespeaker_hubert_tpu/ssl/dataset.py`: N global and M local
crops per utterance, each with its own reverb / noise draw.  The list
striping, buffer shuffle and crop choice are data/dataset.py's, and the
`random.Random` and numpy draws come in the JAX package's order, so a seed,
a data list and the same aug stores give the same batches (`raw` and
`shard` lists).  The host only selects crops and augmentation parameters;
the train step applies reverb / noise and fbank on the device (see
bin/train_dino.py).

Batch layout (numpy, crop-count axes fixed):
  global_wav (B, n_global, Lg), local_wav (B, n_local, Ll)
  per crop: {global,local}_{rir (.., R), noise (.., L), aug_type (..,),
  snr (..,)}
`local_num: 0` gives (B, 0, Ll) local fields, as the contrastive trainer
uses it.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..data.aug_store import AugStore, snr_range_for_key
from ..data.dataset import (
    _random_chunk,
    buffer_shuffle,
    chunk_samples_for_frames,
    iter_raw_list,
    iter_tar_shards,
    shard_list_for_rank,
)

__all__ = ["SSLPipeline"]


class SSLPipeline:
    def __init__(
        self,
        data_list: Sequence[str],
        data_type: str = "raw",
        global_frames: int = 200,
        global_num: int = 2,
        local_frames: int = 100,
        local_num: int = 4,
        batch_size: int = 32,
        aug_prob: float = 0.6,
        rir_max_samples: int = 8000,
        shuffle_size: int = 1000,
        min_frames: int = 100,
        reverb_store: Optional[AugStore] = None,
        noise_store: Optional[AugStore] = None,
        rank: int = 0,
        world_size: int = 1,
        seed: int = 42,
    ):
        self.data_list = list(data_list)
        self.data_type = data_type
        self.global_num = global_num
        self.local_num = local_num
        self.batch_size = batch_size
        self.aug_prob = aug_prob
        self.rir_max = rir_max_samples
        self.shuffle_size = shuffle_size
        self.reverb_store = reverb_store
        self.noise_store = noise_store
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.epoch = 0
        self.global_samples = chunk_samples_for_frames(global_frames)
        self.local_samples = chunk_samples_for_frames(local_frames)
        self.min_samples = int(min_frames * 160)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _crop_group(self, wav, n, length, rng, nprng):
        crops = np.zeros((n, length), np.float32)
        rirs = np.zeros((n, self.rir_max), np.float32)
        noises = np.zeros((n, length), np.float32)
        aug_types = np.zeros((n,), np.int32)
        snrs = np.zeros((n,), np.float32)
        for i in range(n):
            crops[i] = _random_chunk(wav, length, rng)
            if self.aug_prob > rng.random() and (self.reverb_store or self.noise_store):
                at = rng.randint(1, 2)
                if at == 1 and self.reverb_store is not None:
                    _, r = self.reverb_store.random_one(nprng)
                    r = np.asarray(r, np.float32)[: self.rir_max]
                    rirs[i, : len(r)] = r
                    aug_types[i] = 1
                elif self.noise_store is not None:
                    key, nz = self.noise_store.random_one(nprng)
                    noises[i] = _random_chunk(np.asarray(nz, np.float32), length, rng)
                    lo, hi = snr_range_for_key(key)
                    snrs[i] = rng.uniform(lo, hi)
                    aug_types[i] = 2
        return crops, rirs, noises, aug_types, snrs

    def _samples(self) -> Iterator[dict]:
        shards = shard_list_for_rank(self.data_list, self.epoch, self.rank, self.world_size,
                                     seed=self.seed)
        it = iter_tar_shards(shards) if self.data_type == "shard" else iter_raw_list(shards)
        rng = random.Random(self.seed + 31 * self.epoch + self.rank)
        nprng = np.random.default_rng(self.seed + 97 * self.epoch + self.rank)
        for s in buffer_shuffle(it, self.shuffle_size, rng):
            wav = s["wav"]
            if len(wav) < self.min_samples:
                continue
            g = self._crop_group(wav, self.global_num, self.global_samples, rng, nprng)
            loc = self._crop_group(wav, self.local_num, self.local_samples, rng, nprng)
            out = {"key": s["key"]}
            for prefix, group in (("global", g), ("local", loc)):
                for name, x in zip(("wav", "rir", "noise", "aug_type", "snr"), group):
                    out[f"{prefix}_{name}"] = x
            yield out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        buf: List[dict] = []
        for s in self._samples():
            buf.append(s)
            if len(buf) == self.batch_size:
                yield {k: np.stack([x[k] for x in buf]) for k in buf[0] if k != "key"}
                buf = []
