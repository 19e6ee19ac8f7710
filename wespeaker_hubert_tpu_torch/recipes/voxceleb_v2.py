"""VoxCeleb2 supervised speaker-verification recipe on the port.

Counterpart of `examples/voxceleb/v2/run.py`, stages 1-7, with the same
arguments, file layout and printed lines, each stage through the port's own
bin modules on `--device` (CUDA unless the caller asks for the CPU):

  1. aug stores: `DATA/musan/wav.scp` and `DATA/rirs/wav.scp` ->
     `DATA/musan_aug_store`, `DATA/rirs_aug_store`;
  2. data lists: tar shards + `shard.list` of `DATA/vox2_dev` (when
     `data_type: shard`), and `raw.list` of `vox2_dev` and `vox1`;
  3. training (bin/train.py);
  4. checkpoint averaging (`EXP/avg_model.pt`) and extraction of both raw
     lists (`EXP/embeddings/{vox1,vox2_dev}.npz`);
  5. the train-set mean vector, cosine scores of each trial file and their
     EER / minDCF;
  6. the speaker-mean cohort and AS-Norm (`*.score.asnorm`);
  7. QMF calibration trained on trials generated from the training set,
     applied to each AS-Norm file (`*.score.asnorm.qmf`).

    python -m wespeaker_hubert_tpu_torch.recipes.voxceleb_v2 --stage 1 \\
        --stop_stage 7 --config examples/voxceleb/v2/conf/ecapa_tdnn.yaml \\
        --data_root data --trials data/vox1/trials/vox1_O_cleaned.kaldi \\
        [--device cuda|cpu] [a.b.c=value ...]

`a.b.c=value` overrides apply to the config (utils/config.py).  Stages 8
(export) and 9 (the large-margin fine-tune, which re-enters stage 8) are not
ported yet (ROADMAP.md queue 1, item 9): asking for them raises before any
stage runs.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..backend.calibration import apply_calibration, gather_factors
from ..bin.average_model import average_model
from ..bin.extract import extract
from ..bin.score import compute_metrics, score_norm, score_trials
from ..bin.score_calibration import (
    load_durations,
    train_calibration_on_train_set,
    write_calibrated,
)
from ..bin.tools import build_aug_store, make_raw_list, make_shard_list, vector_mean, wav2dur
from ..bin.train import train
from ..utils.config import apply_overrides, load_config
from ..utils.embeddings import load_embeddings

__all__ = ["parse_args", "run_stages", "main"]

UNPORTED_STAGES = {8: "export", 9: "the large-margin fine-tune"}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stage", type=int, default=3)
    p.add_argument("--stop_stage", type=int, default=6)
    p.add_argument("--config", default="conf/ecapa_tdnn.yaml")
    p.add_argument("--data_root", default="data")
    p.add_argument("--trials", nargs="+", default=[])
    p.add_argument("--asnorm_top_n", type=int, default=300)
    p.add_argument("--calibration_trial_num", type=int, default=10000,
                   help="trial pairs for QMF training")
    p.add_argument("--lm_config", default=None,
                   help="large-margin fine-tune config for stage 9 (not ported yet)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", help="a.b.c=value config overrides")
    return p.parse_args(argv)


def _refuse_unported(stage: int, stop_stage: int) -> None:
    asked = [s for s in UNPORTED_STAGES if stage <= s <= stop_stage]
    if asked:
        raise NotImplementedError(
            "stage " + " and ".join(f"{s} ({UNPORTED_STAGES[s]})" for s in asked)
            + " is not ported yet (ROADMAP.md queue 1, item 9); run --stop_stage 7")


def _metrics_line(path: str, lines: List[str]) -> None:
    eer, mindcf = compute_metrics(path)
    line = f"{os.path.basename(path)}: EER {eer:.3f}% minDCF {mindcf:.4f}"
    print(line, flush=True)
    lines.append(line)


def run_stages(args: argparse.Namespace, config: Dict, stage: int,
               stop_stage: int) -> Dict[int, Dict]:
    """Run stages [stage, stop_stage]; returns {stage: {"s": seconds,
    "lines": printed result lines}}."""
    _refuse_unported(stage, stop_stage)
    device = args.device
    exp_dir = config["exp_dir"]
    models_dir = os.path.join(exp_dir, "models")
    avg_ckpt = os.path.join(exp_dir, "avg_model.pt")
    emb_dir = os.path.join(exp_dir, "embeddings")
    score_dir = os.path.join(exp_dir, "scores")
    mean_vec_path = os.path.join(emb_dir, "vox2_dev_mean.npy")
    cohort_path = os.path.join(emb_dir, "vox2_dev_spk_mean.npz")
    done: Dict[int, Dict] = {}

    def begin(s: int, what: str):
        print(f"stage {s}: {what}", flush=True)
        done[s] = {"lines": [], "t0": time.perf_counter()}
        return done[s]["lines"]

    def end(s: int):
        done[s]["s"] = time.perf_counter() - done[s].pop("t0")

    def in_range(s: int) -> bool:
        return stage <= s <= stop_stage

    if in_range(1):
        begin(1, "build aug stores (MUSAN + RIRs)")
        for src, dst in (("musan", "musan_aug_store"), ("rirs", "rirs_aug_store")):
            build_aug_store(os.path.join(args.data_root, src, "wav.scp"),
                            os.path.join(args.data_root, dst))
        end(1)

    if in_range(2):
        begin(2, "data lists")
        for dset in ("vox2_dev", "vox1"):
            d = os.path.join(args.data_root, dset)
            if config.get("data_type", "shard") == "shard" and dset == "vox2_dev":
                make_shard_list(os.path.join(d, "wav.scp"), os.path.join(d, "utt2spk"),
                                os.path.join(d, "shards"), os.path.join(d, "shard.list"))
            make_raw_list(os.path.join(d, "wav.scp"), os.path.join(d, "utt2spk"),
                          os.path.join(d, "raw.list"))
        end(2)

    if in_range(3):
        begin(3, "train")
        train(config, device=device)
        end(3)

    if in_range(4):
        begin(4, "average + extract")
        average_model(models_dir, avg_ckpt, num=config.get("num_avg", 10))
        for name in ("vox1", "vox2_dev"):
            extract(config, os.path.join(args.data_root, name, "raw.list"), avg_ckpt,
                    os.path.join(emb_dir, f"{name}.npz"), device=device)
        end(4)

    if in_range(5):
        lines = begin(5, "cosine score + metrics")
        # the train-set mean vector, subtracted before scoring
        _, train_emb = load_embeddings(os.path.join(emb_dir, "vox2_dev.npz"))
        np.save(mean_vec_path, train_emb.mean(0))
        for f in score_trials(os.path.join(emb_dir, "vox1.npz"), args.trials, score_dir,
                              mean_vec_path, device=device):
            _metrics_line(f, lines)
        end(5)

    if in_range(6):
        lines = begin(6, "AS-Norm")
        vector_mean(os.path.join(emb_dir, "vox2_dev.npz"),
                    os.path.join(args.data_root, "vox2_dev", "utt2spk"), cohort_path)
        for trial in args.trials:
            base = os.path.join(score_dir, os.path.basename(trial) + ".score")
            normed = score_norm(base, base + ".asnorm", os.path.join(emb_dir, "vox1.npz"),
                                cohort_path, method="asnorm", top_n=args.asnorm_top_n,
                                mean_vec_path=mean_vec_path, device=device)
            _metrics_line(normed, lines)
        end(6)

    if in_range(7):
        lines = begin(7, "QMF calibration")
        # trained on trials generated from the training set, never on the
        # evaluation trials (whose labels would leak into the calibrator)
        params, loss, n_cal = train_calibration_on_train_set(
            os.path.join(args.data_root, "vox2_dev"), os.path.join(emb_dir, "vox2_dev.npz"),
            cohort_path, mean_vec_path, exp_dir, score_dir, top_n=args.asnorm_top_n,
            each_trial_num=args.calibration_trial_num, device=device)
        print(f"  calibration trained on {n_cal} trials (Cllr {loss:.4f})", flush=True)
        dur_path = os.path.join(args.data_root, "vox1", "utt2dur")
        if not os.path.exists(dur_path):
            wav2dur(os.path.join(args.data_root, "vox1", "wav.scp"), dur_path)
        durations = load_durations(dur_path)
        for trial in args.trials:
            normed = os.path.join(score_dir, os.path.basename(trial) + ".score.asnorm")
            with open(normed) as f:
                factors, meta = gather_factors(list(f), durations)
            out = normed + ".qmf"
            write_calibrated(out, meta, apply_calibration(params, factors))
            _metrics_line(out, lines)
        end(7)
    return done


def main(argv: Optional[List[str]] = None) -> Dict[int, Dict]:
    import logging

    import torch

    args = parse_args(argv)
    _refuse_unported(args.stage, args.stop_stage)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = apply_overrides(load_config(args.config), args.overrides)
    return run_stages(args, config, args.stage, args.stop_stage)


if __name__ == "__main__":
    main()
