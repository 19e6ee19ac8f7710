"""QMF score calibration.

Counterpart of `wespeaker_hubert_tpu/bin/score_calibration.py`:

    python -m wespeaker_hubert_tpu_torch.bin.score_calibration \\
        --train_scores dev.asnorm --eval_scores eval.asnorm --output eval.qmf \\
        [--utt2dur utt2dur] [--max_dur 20]

`train_calibration_on_train_set` fits the calibration on trials generated
from the training set (never on the evaluation trials, which would leak
their labels into the calibrator); `calibrate_scores` fits on one labeled
AS-Norm score file and applies the fit to another.  The factors and the
Cllr fit are backend/calibration.py's; the scoring runs on `device`.
"""

from __future__ import annotations

import os

import numpy as np

from ..backend.calibration import apply_calibration, gather_factors, train_calibration

__all__ = ["train_calibration_on_train_set", "calibrate_scores", "main"]


def train_calibration_on_train_set(
    train_dir: str,
    emb_path: str,
    cohort_path: str,
    mean_vec_path: str,
    exp_dir: str,
    score_dir: str,
    top_n: int = 300,
    each_trial_num: int = 10000,
    device="cuda",
):
    """Durations of `train_dir/wav.scp` (utt2dur, written if absent) ->
    calibration trials from them and `train_dir/utt2spk`
    (`exp_dir/calibration.trials`) -> cosine scores -> AS-Norm -> the QMF
    factors -> the Cllr fit.  Returns (params, cllr, number of trials)."""
    from .score import score_norm, score_trials
    from .tools import generate_calibration_trial, wav2dur

    cal_dur = os.path.join(train_dir, "utt2dur")
    if not os.path.exists(cal_dur):
        wav2dur(os.path.join(train_dir, "wav.scp"), cal_dur)
    cal_trials = os.path.join(exp_dir, "calibration.trials")
    generate_calibration_trial(cal_dur, os.path.join(train_dir, "utt2spk"), cal_trials,
                               each_trial_num=each_trial_num)
    cal_score = score_trials(emb_path, [cal_trials], score_dir, mean_vec_path,
                             device=device)[0]
    cal_normed = score_norm(cal_score, cal_score + ".asnorm", emb_path, cohort_path,
                            method="asnorm", top_n=top_n, mean_vec_path=mean_vec_path,
                            device=device)
    with open(cal_normed) as f:
        factors, meta = gather_factors(list(f), load_durations(cal_dur))
    labels = np.asarray([1 if m[2] == "target" else 0 for m in meta])
    params, loss = train_calibration(factors, labels)
    return params, loss, len(meta)


def load_durations(path):
    """utt2dur -> {utt: seconds}, or None without a path."""
    if not path:
        return None
    with open(path) as f:
        return {u: float(d) for u, d in (ln.split()[:2] for ln in f)}


def calibrate_scores(
    train_score_file: str,
    eval_score_file: str,
    output_file: str,
    utt2dur: str = None,
    max_dur: float = 20.0,
):
    """Fit the linear QMF on a labeled AS-Norm score file, apply it to
    another and write `enroll test score [label]` lines; returns (params,
    cllr)."""
    durations = load_durations(utt2dur)
    with open(train_score_file) as f:
        factors, meta = gather_factors(list(f), durations, max_dur)
    labels = np.asarray([1 if m[2] in ("target", "tgt") else 0 for m in meta])
    params, loss = train_calibration(factors, labels)
    with open(eval_score_file) as f:
        e_factors, e_meta = gather_factors(list(f), durations, max_dur)
    write_calibrated(output_file, e_meta, apply_calibration(params, e_factors))
    return params, loss


def write_calibrated(path, meta, scores) -> None:
    with open(path, "w") as f:
        for (e, t, lab), s in zip(meta, scores):
            if lab is None:
                f.write(f"{e} {t} {s:.5f}\n")
            else:
                f.write(f"{e} {t} {s:.5f} {lab}\n")


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train_scores", required=True,
                   help="labeled AS-Norm score file (with the QMF columns)")
    p.add_argument("--eval_scores", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--utt2dur", default=None)
    p.add_argument("--max_dur", type=float, default=20.0)
    args = p.parse_args()
    params, loss = calibrate_scores(args.train_scores, args.eval_scores, args.output,
                                    args.utt2dur, args.max_dur)
    print(f"calibration cllr {loss:.4f}; params {np.round(params, 4)}")


if __name__ == "__main__":
    main()
