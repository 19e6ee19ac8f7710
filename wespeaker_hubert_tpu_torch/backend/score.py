"""Trial scoring on the device: cosine scores and AS-Norm cohort statistics.

Counterpart of `wespeaker_hubert_tpu/backend/score.py`.  A trial list is
scored as two row gathers and a row-wise dot product of L2-normalized
embeddings; the cohort statistics are one float32 `emb @ cohort.T`, then
`torch.topk` and the mean and population std (ddof 0) of the top N.  Plain
PyTorch on whatever device the caller names: no kernel of the JAX package
sits here (JAX computes it outside Pallas).  The embeddings are float32 and
TF32 must be off for the cohort product (`torch.backends.cuda.matmul.
allow_tf32`, off unless a caller sets it).  `apply_asnorm` works in float64
on the host, as JAX's does.  Score files and the EER stay on the host
(backend/metrics.py, bin/score.py).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "l2_normalize",
    "cosine_scores",
    "trial_cosine_scores",
    "cohort_mean_std",
    "apply_asnorm",
]

Device = Union[str, torch.device]
# rows of `emb` per cohort product, so the (rows, cohort) scores stay bounded
COHORT_ROW_BLOCK = 65536


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim, keepdim=True), eps)


def cosine_scores(enroll: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """Row-paired cosine similarity: (N, D), (N, D) -> (N,)."""
    e = l2_normalize(enroll.float())
    t = l2_normalize(test.float())
    return torch.sum(e * t, dim=-1)


def trial_cosine_scores(
    embeddings: np.ndarray,
    enroll_idx: np.ndarray,
    test_idx: np.ndarray,
    mean_vec: Optional[np.ndarray] = None,
    device: Device = "cuda",
) -> np.ndarray:
    """Cosine scores of trials (enroll_idx[i], test_idx[i]) over the rows of
    `embeddings` (U, D), after subtracting `mean_vec` (the train-set mean)
    and L2-normalizing every row once; (N,) float32 on the host."""
    device = torch.device(device)
    emb = torch.as_tensor(np.asarray(embeddings, np.float32)).to(device)
    if mean_vec is not None:
        emb = emb - torch.as_tensor(np.asarray(mean_vec, np.float32)).to(device)
    emb = l2_normalize(emb)
    e_idx = torch.as_tensor(np.asarray(enroll_idx, np.int64)).to(device)
    t_idx = torch.as_tensor(np.asarray(test_idx, np.int64)).to(device)
    return torch.sum(emb[e_idx] * emb[t_idx], dim=-1).cpu().numpy()


def cohort_mean_std(
    emb: np.ndarray, cohort: np.ndarray, top_n: int, device: Device = "cuda", mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per row of `emb`, the mean and population std of its top-N cosine
    scores against `cohort` (S-Norm: top_n = len(cohort); top_n is clamped
    to the cohort's size).  Rows go through in blocks of COHORT_ROW_BLOCK."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (cohort statistics sharded over devices) is not ported yet "
            "(ROADMAP.md queue 1, item 10)")
    device = torch.device(device)
    top_n = min(int(top_n), len(cohort))
    c = l2_normalize(torch.as_tensor(np.asarray(cohort, np.float32)).to(device))
    e_all = torch.as_tensor(np.asarray(emb, np.float32))
    means, stds = [], []
    for s in range(0, len(e_all), COHORT_ROW_BLOCK):
        e = l2_normalize(e_all[s:s + COHORT_ROW_BLOCK].to(device))
        top = torch.topk(e @ c.T, top_n, dim=1).values
        means.append(top.mean(dim=1))
        stds.append(top.std(dim=1, correction=0))
    if not means:
        return np.zeros((0,), np.float32), np.zeros((0,), np.float32)
    return torch.cat(means).cpu().numpy(), torch.cat(stds).cpu().numpy()


def apply_asnorm(
    scores: np.ndarray,
    enroll_idx: np.ndarray,
    test_idx: np.ndarray,
    enroll_mean: np.ndarray,
    enroll_std: np.ndarray,
    test_mean: np.ndarray,
    test_std: np.ndarray,
) -> np.ndarray:
    """AS-Norm: 0.5 * ((s - mu_e) / sig_e + (s - mu_t) / sig_t), float64,
    each std floored at 1e-8."""
    s = np.asarray(scores, np.float64)
    em = np.asarray(enroll_mean)[enroll_idx]
    es = np.maximum(np.asarray(enroll_std)[enroll_idx], 1e-8)
    tm = np.asarray(test_mean)[test_idx]
    ts = np.maximum(np.asarray(test_std)[test_idx], 1e-8)
    return 0.5 * ((s - em) / es + (s - tm) / ts)
