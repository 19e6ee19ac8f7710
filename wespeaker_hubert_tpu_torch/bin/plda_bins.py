"""Standalone PLDA commands: train / eval / adapt.

Counterpart of `wespeaker_hubert_tpu/bin/plda_bins.py`, with its arguments
plus `--device` (CUDA unless the caller asks for the CPU):

    python -m wespeaker_hubert_tpu_torch.bin.train_plda --emb train.npz \\
        --utt2spk utt2spk --out plda.npz [--iter 5]
    python -m wespeaker_hubert_tpu_torch.bin.eval_plda --model_path plda.npz \\
        --enroll_emb enroll.npz --test_emb test.npz --trials trials \\
        --score_path out.score [--enroll_utt2spk utt2mdl] [--multisession_avg] \\
        [--type wespeaker|kaldi]
    python -m wespeaker_hubert_tpu_torch.bin.adapt_plda --mdl_org plda.npz \\
        --adp_emb indomain.npz --mdl_adp plda_adapt.npz \\
        [--across_class_scale 0.5] [--within_class_scale 0.5] [--mdl_format wespeaker|kaldi]

Embedding sets are `.npz` (utils/embeddings.py); a Kaldi binary PLDA model
loads through backend/kaldi_io.py.  The PLDA runs in float64 on the device
(backend/plda.py); score files are `enroll test score [label]`, `{:.5f}`.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np

from ..backend.plda import TwoCovPLDA
from ..utils.embeddings import embeddings_dict, load_embeddings
from .score import compute_metrics, read_trials

__all__ = ["train_plda", "eval_plda", "adapt_plda", "main_train", "main_eval", "main_adapt"]


def _read_utt2spk(path: str) -> Dict[str, str]:
    return {u: s for u, s in (ln.split()[:2] for ln in open(path) if ln.strip())}


def train_plda(
    emb_path: str,
    utt2spk_path: str,
    out_path: str,
    em_iters: int = 5,
    normalize_length: bool = True,
    device="cuda",
) -> TwoCovPLDA:
    """Train a two-covariance PLDA on the labeled rows of an embedding set;
    speakers in the order they first appear."""
    keys, emb = load_embeddings(emb_path)
    utt2spk = _read_utt2spk(utt2spk_path)
    order: Dict[str, int] = {}
    rows = [i for i, k in enumerate(keys) if k in utt2spk]
    labels = np.asarray([order.setdefault(utt2spk[keys[i]], len(order)) for i in rows])
    plda = TwoCovPLDA(dim=emb.shape[1], normalize_length=normalize_length, device=device)
    plda.train_rows(emb[rows], labels, num_em_iters=em_iters)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plda.save(out_path)
    return plda


def _load_model(path: str, kaldi_format: bool = False, device="cuda") -> TwoCovPLDA:
    if kaldi_format:
        from ..backend.kaldi_io import load_kaldi_plda

        return load_kaldi_plda(path, device=device)
    return TwoCovPLDA.load(path, device=device)


def eval_plda(
    model_path: str,
    enroll_emb: str,
    test_emb: str,
    trials_path: str,
    score_path: str,
    enroll_utt2spk: Optional[str] = None,
    multisession_avg: bool = False,
    kaldi_format: bool = False,
    print_metrics: bool = True,
    device="cuda",
):
    """Score trials with a trained PLDA: enrollment sessions grouped into
    models by `enroll_utt2spk` (averaged first with multisession_avg);
    returns (score_path, EER, minDCF), the metrics None without labels."""
    plda = _load_model(model_path, kaldi_format, device)
    e_keys, e_emb = load_embeddings(enroll_emb)
    u2s = _read_utt2spk(enroll_utt2spk) if enroll_utt2spk else {}
    enroll: Dict[str, list] = {}
    for k, e in zip(e_keys, e_emb):
        enroll.setdefault(u2s.get(k, k), []).append(e)
    enroll_arr = {k: np.stack(v) for k, v in enroll.items()}
    if multisession_avg:
        enroll_arr = {k: v.mean(0, keepdims=True) for k, v in enroll_arr.items()}
    test = embeddings_dict(test_emb)

    enroll_ids, test_ids, labels = read_trials(trials_path)
    trials = list(zip(enroll_ids, test_ids))
    scores = plda.score_trials(enroll_arr, test, trials)
    os.makedirs(os.path.dirname(score_path) or ".", exist_ok=True)
    with open(score_path, "w") as f:
        for (e, t), s, lab in zip(trials, scores, labels):
            f.write(f"{e} {t} {s:.5f} {lab or ''}".rstrip() + "\n")
    if print_metrics and labels and labels[0] is not None:
        eer, mindcf = compute_metrics(score_path)
        print(f"{os.path.basename(score_path)}: EER {eer:.3f}% minDCF {mindcf:.4f}")
        return score_path, eer, mindcf
    return score_path, None, None


def adapt_plda(
    model_path: str,
    adapt_emb: str,
    out_path: str,
    across_class_scale: float = 0.5,
    within_class_scale: float = 0.5,
    kaldi_format: bool = False,
    device="cuda",
) -> TwoCovPLDA:
    """Unsupervised domain adaptation on an unlabeled in-domain set."""
    plda = _load_model(model_path, kaldi_format, device)
    _, emb = load_embeddings(adapt_emb)
    adapted = plda.adapt(emb, ac_scale=across_class_scale, wc_scale=within_class_scale)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    adapted.save(out_path)
    return adapted


def _parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main_train(argv=None):
    p = _parser("train a two-covariance PLDA")
    p.add_argument("--emb", required=True, help="training embeddings .npz")
    p.add_argument("--utt2spk", required=True)
    p.add_argument("--out", required=True, help="output model .npz")
    p.add_argument("--iter", type=int, default=5)
    a = p.parse_args(argv)
    train_plda(a.emb, a.utt2spk, a.out, em_iters=a.iter, device=a.device)


def main_eval(argv=None):
    p = _parser("score trials with a PLDA")
    p.add_argument("--model_path", required=True)
    p.add_argument("--enroll_emb", required=True)
    p.add_argument("--test_emb", required=True)
    p.add_argument("--trials", required=True)
    p.add_argument("--score_path", required=True)
    p.add_argument("--enroll_utt2spk", default=None)
    p.add_argument("--multisession_avg", action="store_true")
    p.add_argument("--type", default="wespeaker", choices=["wespeaker", "kaldi"])
    a = p.parse_args(argv)
    eval_plda(a.model_path, a.enroll_emb, a.test_emb, a.trials, a.score_path,
              enroll_utt2spk=a.enroll_utt2spk, multisession_avg=a.multisession_avg,
              kaldi_format=a.type == "kaldi", device=a.device)


def main_adapt(argv=None):
    p = _parser("adapt a PLDA to a new domain")
    p.add_argument("--mdl_org", required=True)
    p.add_argument("--adp_emb", required=True)
    p.add_argument("--mdl_adp", required=True)
    p.add_argument("--across_class_scale", type=float, default=0.5)
    p.add_argument("--within_class_scale", type=float, default=0.5)
    p.add_argument("--mdl_format", default="wespeaker", choices=["wespeaker", "kaldi"])
    a = p.parse_args(argv)
    adapt_plda(a.mdl_org, a.adp_emb, a.mdl_adp, across_class_scale=a.across_class_scale,
               within_class_scale=a.within_class_scale, kaldi_format=a.mdl_format == "kaldi",
               device=a.device)
