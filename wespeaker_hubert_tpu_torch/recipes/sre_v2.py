"""NIST SRE16 recipe on the port.

Counterpart of `examples/sre/v2/run.py`, with its arguments, file layout and
printed lines plus `--device` (CUDA unless the caller asks for the CPU) and
`a.b.c=value` config overrides:

  1. aug stores (MUSAN + RIRs);
  2. data lists with VAD cropping: tar shards (with `data_type: shard`) and a
     raw list of `swbd_sre`, raw lists of the four evaluation sets (an
     identity utt2spk written for the unlabeled ones);
  3. training on `swbd_sre` (bin/train.py);
  4. checkpoint averaging (`EXP/avg_model.pt`) and extraction of `sre`,
     `sre16_major`, `sre16_eval_enroll` and `sre16_eval_test`;
  5. cosine scoring of the trials with the `sre16_major` mean subtracted,
     on the device (backend/score.py);
  6. PLDA trained on `sre`, multisession scoring, BUT adaptation on
     `sre16_major` and rescoring (`backend_stage`: bin/plda_bins, float64 on
     the device); also run alone with explicit `--train_emb ...` sets;
  7. export: the model directory `EXP/exported` and its feats -> embedding
     `torch.export` program `EXP/exported/model.pt2`.

    python -m wespeaker_hubert_tpu_torch.recipes.sre_v2 --stage 1 --stop_stage 7 \\
        --config examples/voxceleb/v2/conf/resnet34.yaml --data_root data \\
        --trials data/sre16_eval_test/trials [--device cuda|cpu] \\
        dataset_args.resample_rate=8000 dataset_args.fbank_args.num_mel_bins=64 \\
        model_args.feat_dim=64 [a.b.c=value ...]

Data layout under --data_root:
  swbd_sre/{wav.scp,utt2spk[,vad]}       extractor training
  sre/{wav.scp,utt2spk[,vad]}            PLDA training
  sre16_major/{wav.scp[,vad]}            unlabeled in-domain adaptation
  sre16_eval_enroll/{wav.scp,utt2spk[,vad]}
  sre16_eval_test/{wav.scp[,vad]}
  musan/wav.scp  rirs/wav.scp            augmentation sources
SRE's audio is 8 kHz telephone speech: `dataset_args.resample_rate` names
the wavs' rate (the pipeline does not resample).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..backend.score import trial_cosine_scores
from ..bin.average_model import average_model
from ..bin.export_model import export_model, export_program
from ..bin.extract import extract
from ..bin.plda_bins import adapt_plda, eval_plda, train_plda
from ..bin.score import compute_metrics, read_trials
from ..bin.tools import build_aug_store, make_raw_list, make_shard_list
from ..bin.train import train
from ..utils.config import apply_overrides, load_config
from ..utils.embeddings import load_embeddings

__all__ = ["EVAL_SETS", "parse_args", "backend_stage", "run_stages", "main"]

EVAL_SETS = ("sre", "sre16_major", "sre16_eval_enroll", "sre16_eval_test")


def _utt2spk(path):
    return {u: s for u, s in (ln.split()[:2] for ln in open(path))}


def _write_scores(path, trials, scores, labels) -> None:
    with open(path, "w") as f:
        for (e, t), s, lab in zip(trials, scores, labels):
            f.write(f"{e} {t} {s:.5f} {lab or ''}\n".rstrip() + "\n")


def _report(path, tag, labels, lines) -> None:
    if labels and labels[0] is not None:
        eer, mindcf = compute_metrics(path)
        line = f"{tag}: EER {eer:.3f}% minDCF {mindcf:.4f}"
        print(line, flush=True)
        lines.append(line)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stage", type=int, default=6)
    p.add_argument("--stop_stage", type=int, default=6)
    p.add_argument("--config", default=None, help="train config (stages 2-7)")
    p.add_argument("--data_root", default="data")
    p.add_argument("--trials", default=None)
    p.add_argument("--out_dir", default="exp/sre_scores")
    p.add_argument("--em_iters", type=int, default=5)
    # the stage-6 entry alone: explicit embedding sets
    p.add_argument("--train_emb", default=None, help="PLDA training npz")
    p.add_argument("--train_utt2spk", default=None)
    p.add_argument("--enroll_emb", default=None)
    p.add_argument("--enroll_utt2spk", default=None)
    p.add_argument("--test_emb", default=None)
    p.add_argument("--adapt_emb", default=None, help="unlabeled in-domain npz")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", help="a.b.c=value config overrides")
    return p.parse_args(argv)


def backend_stage(
    train_emb: str,
    train_utt2spk: str,
    enroll_emb: str,
    enroll_utt2spk: str,
    test_emb: str,
    trials_path: str,
    out_dir: str,
    adapt_emb: Optional[str] = None,
    em_iters: int = 5,
    device="cuda",
) -> List[str]:
    """Stage 6: PLDA training -> multisession scoring -> BUT adaptation ->
    rescoring, through bin/plda_bins; writes `plda.npz`, `plda.score` (and
    `plda_adapt.npz`, `plda_adapt.score`) under out_dir; returns the
    printed EER lines."""
    os.makedirs(out_dir, exist_ok=True)
    models = [("plda", os.path.join(out_dir, "plda.npz"))]
    train_plda(train_emb, train_utt2spk, models[0][1], em_iters=em_iters, device=device)
    if adapt_emb:
        models.append(("plda_adapt", os.path.join(out_dir, "plda_adapt.npz")))
        adapt_plda(models[0][1], adapt_emb, models[1][1], device=device)
    labels = read_trials(trials_path)[2]
    lines: List[str] = []
    for tag, model in models:
        out = os.path.join(out_dir, f"{tag}.score")
        eval_plda(model, enroll_emb, test_emb, trials_path, out, enroll_utt2spk=enroll_utt2spk,
                  print_metrics=False, device=device)
        _report(out, tag, labels, lines)
    return lines


def run_stages(args: argparse.Namespace, config: Dict) -> Dict[int, Dict]:
    """Stages [args.stage, args.stop_stage]; returns {stage: {"s": seconds,
    "lines": printed result lines}}."""
    device = args.device
    exp_dir = config["exp_dir"]
    emb_dir = os.path.join(exp_dir, "embeddings")
    avg_ckpt = os.path.join(exp_dir, "avg_model.pt")
    done: Dict[int, Dict] = {}

    def begin(s: int, what: str) -> List[str]:
        print(f"stage {s}: {what}", flush=True)
        done[s] = {"lines": [], "t0": time.perf_counter()}
        return done[s]["lines"]

    def end(s: int) -> None:
        done[s]["s"] = time.perf_counter() - done[s].pop("t0")

    def in_range(s: int) -> bool:
        return args.stage <= s <= args.stop_stage

    def vad_of(dset):
        v = os.path.join(args.data_root, dset, "vad")
        return v if os.path.exists(v) else None

    if in_range(1):
        begin(1, "build aug stores (MUSAN + RIRs)")
        for src in ("musan", "rirs"):
            build_aug_store(os.path.join(args.data_root, src, "wav.scp"),
                            os.path.join(args.data_root, f"{src}_aug_store"))
        end(1)

    if in_range(2):
        begin(2, "data lists (VAD-cropped)")
        d = os.path.join(args.data_root, "swbd_sre")
        if config.get("data_type", "raw") == "shard":
            make_shard_list(os.path.join(d, "wav.scp"), os.path.join(d, "utt2spk"),
                            os.path.join(d, "shards"), os.path.join(d, "shard.list"),
                            vad_file=vad_of("swbd_sre"))
        make_raw_list(os.path.join(d, "wav.scp"), os.path.join(d, "utt2spk"),
                      os.path.join(d, "raw.list"), vad_of("swbd_sre"))
        for dset in EVAL_SETS:
            dd = os.path.join(args.data_root, dset)
            u2s = os.path.join(dd, "utt2spk")
            if not os.path.exists(u2s):
                # unlabeled sets (sre16_major, eval_test): identity map
                with open(os.path.join(dd, "wav.scp")) as ws, open(u2s, "w") as f:
                    for ln in ws:
                        u = ln.split()[0]
                        f.write(f"{u} {u}\n")
            make_raw_list(os.path.join(dd, "wav.scp"), u2s, os.path.join(dd, "raw.list"),
                          vad_of(dset))
        end(2)

    if in_range(3):
        begin(3, "train extractor on swbd_sre")
        train(config, device=device)
        end(3)

    if in_range(4):
        begin(4, "average + extract embeddings")
        average_model(os.path.join(exp_dir, "models"), avg_ckpt, num=config.get("num_avg", 10))
        for dset in EVAL_SETS:
            extract(config, os.path.join(args.data_root, dset, "raw.list"), avg_ckpt,
                    os.path.join(emb_dir, f"{dset}.npz"), device=device)
        end(4)

    if in_range(5):
        lines = begin(5, "cosine scoring (sre16_major mean subtracted)")
        _, major = load_embeddings(os.path.join(emb_dir, "sre16_major.npz"))
        mean = major.mean(0)
        enroll_u2s = _utt2spk(os.path.join(args.data_root, "sre16_eval_enroll", "utt2spk"))
        e_keys, e_emb = load_embeddings(os.path.join(emb_dir, "sre16_eval_enroll.npz"))
        models: Dict[str, list] = {}
        for k, e in zip(e_keys, e_emb):
            models.setdefault(enroll_u2s.get(k, k), []).append(e - mean)
        t_keys, t_emb = load_embeddings(os.path.join(emb_dir, "sre16_eval_test.npz"))
        # one table of the model means and the test rows; the trials index it
        names = list(models)
        table = np.concatenate([np.stack([np.mean(np.stack(models[m]), axis=0)
                                          for m in names]), t_emb - mean])
        m_pos = {m: i for i, m in enumerate(names)}
        t_pos = {k: len(names) + i for i, k in enumerate(t_keys)}
        enroll_ids, test_ids, labels = read_trials(args.trials)
        scores = trial_cosine_scores(table, np.asarray([m_pos[e] for e in enroll_ids]),
                                     np.asarray([t_pos[t] for t in test_ids]), device=device)
        os.makedirs(args.out_dir, exist_ok=True)
        out = os.path.join(args.out_dir, "cosine.score")
        _write_scores(out, zip(enroll_ids, test_ids), scores, labels)
        _report(out, "cosine", labels, lines)
        end(5)

    if in_range(6):
        lines = begin(6, "PLDA + adaptation")
        lines += backend_stage(
            os.path.join(emb_dir, "sre.npz"),
            os.path.join(args.data_root, "sre", "utt2spk"),
            os.path.join(emb_dir, "sre16_eval_enroll.npz"),
            os.path.join(args.data_root, "sre16_eval_enroll", "utt2spk"),
            os.path.join(emb_dir, "sre16_eval_test.npz"),
            args.trials, args.out_dir,
            adapt_emb=os.path.join(emb_dir, "sre16_major.npz"),
            em_iters=args.em_iters, device=device,
        )
        end(6)

    if in_range(7):
        lines = begin(7, "export model bundle")
        out_dir = export_model(exp_dir, os.path.join(exp_dir, "exported"), checkpoint=avg_ckpt)
        export_program(config, avg_ckpt, os.path.join(out_dir, "model.pt2"))
        line = f"  exported {out_dir}"
        print(line, flush=True)
        lines.append(line)
        end(7)
    return done


def main(argv: Optional[List[str]] = None) -> Dict[int, Dict]:
    import logging

    import torch

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.train_emb:
        # the back end alone, on explicit .npz sets
        lines = backend_stage(args.train_emb, args.train_utt2spk, args.enroll_emb,
                              args.enroll_utt2spk, args.test_emb, args.trials, args.out_dir,
                              adapt_emb=args.adapt_emb, em_iters=args.em_iters,
                              device=args.device)
        return {6: {"lines": lines}}
    config = apply_overrides(load_config(args.config), args.overrides)
    return run_stages(args, config)


if __name__ == "__main__":
    main()
