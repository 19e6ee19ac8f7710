"""Verification metrics: EER, minDCF and DET points, in numpy on the host.

A copy of `wespeaker_hubert_tpu/backend/metrics.py`: the FNR / FPR over all
operating points from cumulative sums over the scores sorted ascending, the
EER by linear interpolation at the crossing, and the normalized minimum
detection cost.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "compute_pmiss_pfa",
    "compute_eer",
    "compute_c_norm",
    "eer_from_scores",
    "det_points",
]


def compute_pmiss_pfa(
    scores: np.ndarray, labels: np.ndarray, weights: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """FNR/FPR over all operating points (scores ascending)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels)
    order = np.argsort(scores, kind="stable")
    labels = labels[order]
    if weights is not None:
        weights = np.asarray(weights, dtype=np.float64)[order]
    else:
        weights = np.ones(labels.shape, dtype=np.float64)

    tgt = weights * (labels == 1)
    imp = weights * (labels == 0)
    fnr = np.cumsum(tgt) / np.sum(tgt)
    fpr = 1.0 - np.cumsum(imp) / np.sum(imp)
    return fnr, fpr


def compute_eer(fnr, fpr, scores: Optional[np.ndarray] = None):
    """EER by linear interpolation at the FNR/FPR crossing; optionally also
    return the decision threshold."""
    diff = fnr - fpr
    x1 = np.flatnonzero(diff >= 0)[0]
    x2 = np.flatnonzero(diff < 0)[-1]
    a = (fnr[x1] - fpr[x1]) / (fpr[x2] - fpr[x1] - (fnr[x2] - fnr[x1]))
    eer = fnr[x1] + a * (fnr[x2] - fnr[x1])
    if scores is not None:
        return eer, np.sort(np.asarray(scores))[x1]
    return eer


def compute_c_norm(fnr, fpr, p_target: float, c_miss: float = 1.0, c_fa: float = 1.0):
    """Normalized minimum detection cost (minDCF)."""
    c_det = np.min(c_miss * fnr * p_target + c_fa * fpr * (1 - p_target))
    c_def = min(c_miss * p_target, c_fa * (1 - p_target))
    return c_det / c_def


def eer_from_scores(scores, labels) -> Tuple[float, float, float]:
    """Convenience: (EER, minDCF@p=0.01, minDCF@p=0.001)."""
    fnr, fpr = compute_pmiss_pfa(scores, labels)
    eer = compute_eer(fnr, fpr)
    return (
        float(eer),
        float(compute_c_norm(fnr, fpr, 0.01)),
        float(compute_c_norm(fnr, fpr, 0.001)),
    )


def det_points(fnr, fpr):
    """Probit-domain DET curve points (for plotting; no matplotlib dep)."""
    from scipy.stats import norm

    return norm.ppf(np.clip(fpr, 1e-10, 1 - 1e-10)), norm.ppf(
        np.clip(fnr, 1e-10, 1 - 1e-10)
    )
