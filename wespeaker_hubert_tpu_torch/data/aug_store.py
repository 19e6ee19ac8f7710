"""Random-access noise / RIR store for augmentation: a copy of `AugStore` and
`snr_range_for_key` from `wespeaker_hubert_tpu/data/aug_store.py`.

Audio lives either as a directory of .npy float32 arrays with an
`index.json` ({key: filename}), built once by `AugStore.build_from_wavs`, or
as an in-memory dict.  Keys prefixed noise / speech / music set the SNR band.
Loads are lazy (memory-mapped) with a bounded cache.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from .wav_io import read_wav

__all__ = ["AugStore", "snr_range_for_key"]


def snr_range_for_key(key: str) -> Tuple[float, float]:
    """SNR band in dB by key prefix."""
    if key.startswith("noise"):
        return (0.0, 15.0)
    if key.startswith("speech"):
        return (10.0, 30.0)
    if key.startswith("music"):
        return (5.0, 15.0)
    return (0.0, 15.0)


class AugStore:
    def __init__(
        self,
        root: Optional[str] = None,
        arrays: Optional[Dict[str, np.ndarray]] = None,
        cache_items: int = 512,
    ):
        self._root = root
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._cache_items = cache_items
        if arrays is not None:
            self.keys = sorted(arrays)
            self._mem = arrays
        else:
            if root is None:
                raise ValueError("AugStore needs a root directory or arrays")
            with open(os.path.join(root, "index.json")) as f:
                self._index = json.load(f)
            self.keys = sorted(self._index)
            self._mem = None

    def __len__(self):
        return len(self.keys)

    def _load(self, key: str) -> np.ndarray:
        if self._mem is not None:
            return self._mem[key]
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        arr = np.load(os.path.join(self._root, self._index[key]), mmap_mode="r")
        self._cache[key] = arr
        if len(self._cache) > self._cache_items:
            self._cache.popitem(last=False)
        return arr

    def random_one(self, rng: np.random.Generator) -> Tuple[str, np.ndarray]:
        """A uniform pick: (key, audio)."""
        key = self.keys[int(rng.integers(0, len(self.keys)))]
        return key, self._load(key)

    @staticmethod
    def build_from_wavs(
        out_dir: str, items: Iterable[Tuple[str, str]], sample_rate: int = 16000
    ) -> "AugStore":
        """items: (key, wav_path).  No resampling: feed sources at the
        training rate."""
        os.makedirs(out_dir, exist_ok=True)
        index = {}
        for key, path in items:
            x, sr = read_wav(path)
            fname = key.replace("/", "_") + ".npy"
            np.save(os.path.join(out_dir, fname), x.astype(np.float32))
            index[key] = fname
        with open(os.path.join(out_dir, "index.json"), "w") as f:
            json.dump(index, f)
        return AugStore(root=out_dir)
