"""Embedding storage: one .npz per set.

Counterpart of `wespeaker_hubert_tpu/utils/embeddings.py`, same keys and
layout:
  keys: (N,) unicode array, utterance ids
  emb:  (N, D) float32
and per-speaker means (`speaker_means`, the AS-Norm cohort).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["save_embeddings", "load_embeddings", "embeddings_dict", "speaker_means"]


def save_embeddings(path: str, keys: List[str], emb: np.ndarray) -> None:
    if len(keys) != len(emb):
        raise ValueError(f"{len(keys)} keys for {len(emb)} embeddings")
    np.savez_compressed(path, keys=np.asarray(keys), emb=np.asarray(emb, np.float32))


def load_embeddings(path: str) -> Tuple[List[str], np.ndarray]:
    data = np.load(path, allow_pickle=False)
    return [str(k) for k in data["keys"]], data["emb"]


def embeddings_dict(path: str) -> Dict[str, np.ndarray]:
    keys, emb = load_embeddings(path)
    return dict(zip(keys, emb))


def speaker_means(
    keys: List[str], emb: np.ndarray, utt2spk: Dict[str, str]
) -> Tuple[List[str], np.ndarray]:
    """Mean embedding per speaker, speakers sorted; utterances without a
    speaker are left out."""
    by_spk: Dict[str, list] = {}
    for k, e in zip(keys, emb):
        spk = utt2spk.get(k)
        if spk is not None:
            by_spk.setdefault(spk, []).append(e)
    spks = sorted(by_spk)
    means = np.stack([np.mean(by_spk[s], axis=0) for s in spks])
    return spks, means
