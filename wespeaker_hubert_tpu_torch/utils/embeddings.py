"""Embedding storage: one .npz per set.

Counterpart of `wespeaker_hubert_tpu/utils/embeddings.py`, same keys and
layout:
  keys: (N,) unicode array, utterance ids
  emb:  (N, D) float32
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["save_embeddings", "load_embeddings"]


def save_embeddings(path: str, keys: List[str], emb: np.ndarray) -> None:
    if len(keys) != len(emb):
        raise ValueError(f"{len(keys)} keys for {len(emb)} embeddings")
    np.savez_compressed(path, keys=np.asarray(keys), emb=np.asarray(emb, np.float32))


def load_embeddings(path: str) -> Tuple[List[str], np.ndarray]:
    data = np.load(path, allow_pickle=False)
    return [str(k) for k in data["keys"]], data["emb"]
