"""Trial scoring, AS-Norm and metrics.

Counterpart of `wespeaker_hubert_tpu/bin/score.py`:

    python -m wespeaker_hubert_tpu_torch.bin.score cosine --emb vox1.npz \\
        --store_dir scores [--mean_vec mean.npy] [--device cuda|cpu] TRIALS...
    python -m wespeaker_hubert_tpu_torch.bin.score norm --score_file S \\
        --output S.asnorm --eval_emb vox1.npz --cohort_emb cohort.npz \\
        [--method asnorm|snorm] [--top_n 300] [--mean_vec mean.npy] [--device ...]
    python -m wespeaker_hubert_tpu_torch.bin.score metrics [--p_target 0.01] SCORES...

Trial files are `enroll test [target|nontarget]` lines; score files are
`enroll test score [label]` with the score as `{:.5f}`.  The AS-Norm file
adds the columns QMF calibration reads: the two embedding magnitudes and the
two cohort means (`{:.4f}`).  The scores are computed on the device
(backend/score.py, CUDA unless the caller asks for the CPU); the EER and
minDCF on the host (backend/metrics.py).
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import numpy as np

from ..backend.metrics import compute_c_norm, compute_eer, compute_pmiss_pfa
from ..backend.score import apply_asnorm, cohort_mean_std, trial_cosine_scores
from ..utils.device import resolve_device
from ..utils.embeddings import load_embeddings

__all__ = ["read_trials", "write_scores", "score_trials", "score_norm", "compute_metrics",
           "main"]

logger = logging.getLogger("score")


def read_trials(path: str) -> Tuple[List[str], List[str], List[Optional[str]]]:
    enroll, test, labels = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            enroll.append(parts[0])
            test.append(parts[1])
            labels.append(parts[2] if len(parts) > 2 else None)
    return enroll, test, labels


def write_scores(path, enroll, test, scores, labels) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for e, t, s, lab in zip(enroll, test, scores, labels):
            if lab is None:
                f.write(f"{e} {t} {s:.5f}\n")
            else:
                f.write(f"{e} {t} {s:.5f} {lab}\n")


def score_trials(
    emb_path: str,
    trial_files: List[str],
    store_dir: str,
    mean_vec_path: Optional[str] = None,
    device="cuda",
) -> List[str]:
    """Cosine-score each trial file against the embedding set; writes
    `store_dir/<trial name>.score` and returns those paths."""
    device = resolve_device(device)
    keys, emb = load_embeddings(emb_path)
    key2idx = {k: i for i, k in enumerate(keys)}
    mean_vec = np.load(mean_vec_path) if mean_vec_path else None
    outputs = []
    for trial in trial_files:
        enroll, test, labels = read_trials(trial)
        e_idx = np.asarray([key2idx[k] for k in enroll])
        t_idx = np.asarray([key2idx[k] for k in test])
        scores = trial_cosine_scores(emb, e_idx, t_idx, mean_vec=mean_vec, device=device)
        out = os.path.join(store_dir, os.path.basename(trial) + ".score")
        write_scores(out, enroll, test, scores, labels)
        outputs.append(out)
    return outputs


def score_norm(
    score_file: str,
    output_file: str,
    eval_emb_path: str,
    cohort_emb_path: str,
    method: str = "asnorm",
    top_n: int = 300,
    mean_vec_path: Optional[str] = None,
    sharded: bool = False,
    device="cuda",
) -> str:
    """AS-Norm (or S-Norm, the whole cohort) of a score file, written in
    the 8-column format `enroll test score label e_mag t_mag e_mean t_mean`
    that QMF calibration reads; returns `output_file`."""
    if sharded:
        raise NotImplementedError("sharded cohort statistics are not ported yet "
                                  "(ROADMAP.md queue 1, item 10)")
    device = resolve_device(device)
    keys, emb = load_embeddings(eval_emb_path)
    _, cohort = load_embeddings(cohort_emb_path)
    mean_vec = np.load(mean_vec_path) if mean_vec_path else 0.0
    emb = emb - mean_vec
    cohort = cohort - mean_vec

    enroll, test, raw, labels = [], [], [], []
    with open(score_file) as f:
        for line in f:
            parts = line.split()
            enroll.append(parts[0])
            test.append(parts[1])
            raw.append(float(parts[2]))
            labels.append(parts[3] if len(parts) > 3 else None)

    uniq = sorted(set(enroll) | set(test))
    key2row = {k: i for i, k in enumerate(keys)}
    sel_emb = emb[np.asarray([key2row[k] for k in uniq])]
    n = len(cohort) if method == "snorm" else top_n
    mean, std = cohort_mean_std(sel_emb, cohort, n, device=device)
    uniq2i = {k: i for i, k in enumerate(uniq)}
    e_i = np.asarray([uniq2i[k] for k in enroll])
    t_i = np.asarray([uniq2i[k] for k in test])
    normed = apply_asnorm(np.asarray(raw), e_i, t_i, mean, std, mean, std)

    mags = np.linalg.norm(sel_emb, axis=1)
    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    with open(output_file, "w") as f:
        for i in range(len(raw)):
            lab = labels[i] if labels[i] is not None else ""
            f.write("{} {} {:.5f} {} {:.4f} {:.4f} {:.4f} {:.4f}\n".format(
                enroll[i], test[i], normed[i], lab,
                mags[e_i[i]], mags[t_i[i]], mean[e_i[i]], mean[t_i[i]]))
    return output_file


def compute_metrics(
    score_file: str, p_target: float = 0.01, c_miss: float = 1.0, c_fa: float = 1.0
) -> Tuple[float, float]:
    """(EER in %, minDCF) of a labeled score file."""
    scores, labels = [], []
    with open(score_file) as f:
        for line in f:
            parts = line.split()
            scores.append(float(parts[2]))
            labels.append(1 if parts[3] == "target" else 0)
    fnr, fpr = compute_pmiss_pfa(np.asarray(scores), np.asarray(labels))
    eer = compute_eer(fnr, fpr) * 100
    mindcf = compute_c_norm(fnr, fpr, p_target, c_miss, c_fa)
    logger.info("%s: EER %.3f%% minDCF(p=%.3g) %.4f", score_file, eer, p_target, mindcf)
    return eer, mindcf


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("cosine")
    s.add_argument("--emb", required=True)
    s.add_argument("--store_dir", required=True)
    s.add_argument("--mean_vec", default=None)
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.add_argument("trials", nargs="+")

    s = sub.add_parser("norm")
    s.add_argument("--score_file", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--eval_emb", required=True)
    s.add_argument("--cohort_emb", required=True)
    s.add_argument("--method", default="asnorm", choices=("asnorm", "snorm"))
    s.add_argument("--top_n", type=int, default=300)
    s.add_argument("--mean_vec", default=None)
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    s = sub.add_parser("metrics")
    s.add_argument("--p_target", type=float, default=0.01)
    s.add_argument("scores", nargs="+")

    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)
    if args.cmd == "cosine":
        score_trials(args.emb, args.trials, args.store_dir, args.mean_vec, device=args.device)
    elif args.cmd == "norm":
        score_norm(args.score_file, args.output, args.eval_emb, args.cohort_emb, args.method,
                   args.top_n, mean_vec_path=args.mean_vec, device=args.device)
    else:
        for sf in args.scores:
            eer, mindcf = compute_metrics(sf, args.p_target)
            print(f"{sf} EER {eer:.3f}% minDCF {mindcf:.4f}")


if __name__ == "__main__":
    main()
