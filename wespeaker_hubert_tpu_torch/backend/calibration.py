"""QMF score calibration (quality measure functions), numpy and scipy.

A copy of `wespeaker_hubert_tpu/backend/calibration.py`: per-trial quality
vectors from the AS-Norm score file (the normed score, min / max / difference
/ ratio of the two durations, of the embedding magnitudes and of the cohort
means), and a linear calibration fit to minimize Cllr with scipy's L-BFGS-B
and the closed-form gradient.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import minimize

__all__ = [
    "reorder_values",
    "gather_factors",
    "cllr",
    "train_calibration",
    "apply_calibration",
]

LOG2 = math.log(2.0)


def reorder_values(a: float, b: float) -> List[float]:
    """(min, max, max-min, max/min) quality quadruple
    (reference :45-50)."""
    lo, hi = (a, b) if a <= b else (b, a)
    return [lo, hi, hi - lo, hi / lo if lo != 0 else 0.0]


def gather_factors(
    score_norm_lines: Sequence[str],
    durations: Optional[Dict[str, float]] = None,
    max_dur: float = 20.0,
) -> Tuple[np.ndarray, List[Tuple[str, str, Optional[str]]]]:
    """Score-norm file lines (enroll test score label e_mag t_mag e_mean
    t_mean — bin/score.py score_norm output) -> (N, F) factor matrix +
    trial meta.  Factor layout matches the reference: [score, dur x4?,
    mag x4, cohort-mean x4]."""
    rows, meta = [], []
    for line in score_norm_lines:
        p = line.split()
        enroll, test, score = p[0], p[1], float(p[2])
        label = p[3] if len(p) > 3 and p[3] in ("target", "nontarget", "tgt", "imp") else None
        off = 4 if label is not None else 3
        e_mag, t_mag, e_mean, t_mean = (float(x) for x in p[off : off + 4])
        feats = [score]
        if durations is not None:
            feats += reorder_values(
                min(durations[enroll], max_dur), min(durations[test], max_dur)
            )
        feats += reorder_values(e_mag, t_mag)
        feats += reorder_values(e_mean, t_mean)
        rows.append(feats)
        meta.append((enroll, test, label))
    return np.asarray(rows, np.float64), meta


def cllr(target_llrs: np.ndarray, nontarget_llrs: np.ndarray) -> float:
    """Calibration loss (reference :83-93)."""

    def nls(x):  # -log(sigmoid(x)) = log1p(exp(-x)), stable
        return np.logaddexp(0.0, -x)

    return 0.5 * (np.mean(nls(target_llrs)) + np.mean(nls(-nontarget_llrs))) / LOG2


def train_calibration(
    factors: np.ndarray, labels: np.ndarray, max_iter: int = 200
) -> Tuple[np.ndarray, float]:
    """Fit s' = w @ x + b minimizing Cllr.  Returns (params (F+1,), cllr).

    labels: 1 target / 0 nontarget.  Init matches the reference
    (weights 1/F, bias 0)."""
    x = np.asarray(factors, np.float64)
    y = np.asarray(labels).astype(bool)
    xt, xn = x[y], x[~y]
    f = x.shape[1]

    def fun(params):
        w, b = params[:f], params[f]
        st = xt @ w + b
        sn = xn @ w + b
        loss = cllr(st, sn)
        sig_t = 1.0 / (1.0 + np.exp(st))        # sigmoid(-st)
        sig_n = 1.0 / (1.0 + np.exp(-sn))       # sigmoid(sn)
        gw = 0.5 * (
            -(sig_t[:, None] * xt).mean(0) + (sig_n[:, None] * xn).mean(0)
        ) / LOG2
        gb = 0.5 * (-sig_t.mean() + sig_n.mean()) / LOG2
        return loss, np.concatenate([gw, [gb]])

    x0 = np.concatenate([np.full(f, 1.0 / f), [0.0]])
    res = minimize(fun, x0, jac=True, method="L-BFGS-B",
                   options={"maxiter": max_iter})
    return res.x, float(res.fun)


def apply_calibration(params: np.ndarray, factors: np.ndarray) -> np.ndarray:
    f = factors.shape[1]
    return factors @ params[:f] + params[f]
