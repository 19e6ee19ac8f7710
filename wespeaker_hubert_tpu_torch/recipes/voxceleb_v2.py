"""VoxCeleb2 supervised speaker-verification recipe on the port.

Counterpart of `examples/voxceleb/v2/run.py`, stages 1-9, with the same
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
     applied to each AS-Norm file (`*.score.asnorm.qmf`);
  8. export (bin/export_model.py): the model directory `EXP/exported`
     (`config.json`, `avg_model.pt`, `mean_vec.npy`) and its feats ->
     embedding `torch.export` program `EXP/exported/model.pt2`;
  9. the large-margin fine-tune: stages 3 to min(stop_stage, 8) again with
     `--lm_config`, its `model_init` the base run's `EXP/avg_model.pt`
     (head included).

    python -m wespeaker_hubert_tpu_torch.recipes.voxceleb_v2 --stage 1 \\
        --stop_stage 9 --config examples/voxceleb/v2/conf/resnet34.yaml \\
        --lm_config examples/voxceleb/v2/conf/resnet_lm.yaml \\
        --data_root data --trials data/vox1/trials/vox1_O_cleaned.kaldi \\
        [--device cuda|cpu] [a.b.c=value ...] [lm.a.b.c=value ...]

`a.b.c=value` overrides apply to the config, `lm.a.b.c=value` ones to the
lm config (utils/config.py).  With stage 9 in range, `--lm_config` is
required and its `exp_dir` must differ from the base one (else bin/train
would resume the base run instead of fine-tuning from `model_init`): both
are checked before any stage runs.

`recipes/cnceleb_v2.py` runs the same stages on CN-Celeb's sets
(`Layout`: the training set, whose embeddings give the mean vector, the
AS-Norm cohort and the QMF trials, and the evaluation set).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..backend.calibration import apply_calibration, gather_factors
from ..bin.average_model import average_model
from ..bin.export_model import export_model, export_program
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

__all__ = ["Layout", "VOXCELEB", "parse_args", "load_configs", "run_stages", "run", "main"]

LM_PREFIX = "lm."


@dataclasses.dataclass(frozen=True)
class Layout:
    """The sets under `--data_root` a recipe reads: `train` (the training
    data; its embeddings give the mean vector, the speaker-mean AS-Norm
    cohort and the QMF calibration trials) and `eval` (the trials' set)."""

    train: str
    eval: str


VOXCELEB = Layout(train="vox2_dev", eval="vox1")


def parse_args(argv: Optional[List[str]] = None, description: str = __doc__,
               **defaults) -> argparse.Namespace:
    """The driver's arguments; `defaults` replace the VoxCeleb ones (a
    recipe of another corpus)."""
    p = argparse.ArgumentParser(description=description.split("\n\n")[0])
    p.add_argument("--stage", type=int, default=3)
    p.add_argument("--stop_stage", type=int, default=6)
    p.add_argument("--config", default="conf/ecapa_tdnn.yaml")
    p.add_argument("--data_root", default="data")
    p.add_argument("--trials", nargs="+", default=[])
    p.add_argument("--asnorm_top_n", type=int, default=300)
    p.add_argument("--calibration_trial_num", type=int, default=10000,
                   help="trial pairs for QMF training")
    p.add_argument("--lm_config", default=None,
                   help="large-margin fine-tune config for stage 9, which re-enters stages 3-8 "
                        "with it")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*",
                   help="a.b.c=value config overrides, lm.a.b.c=value lm config overrides")
    p.set_defaults(**defaults)
    args = p.parse_args(argv)
    if args.stage <= 9 <= args.stop_stage and not args.lm_config:
        # fail before hours of stages 1-8, not at the stage-9 boundary
        p.error("--lm_config is required when stage 9 is in range")
    return args


def load_configs(args: argparse.Namespace) -> Tuple[Dict, Optional[Dict]]:
    """The config and the lm config (None without `--lm_config`), each with
    its overrides; raises if the lm run would share the base `exp_dir`."""
    base = [o for o in args.overrides if not o.startswith(LM_PREFIX)]
    lm = [o[len(LM_PREFIX):] for o in args.overrides if o.startswith(LM_PREFIX)]
    config = apply_overrides(load_config(args.config), base)
    lm_config = apply_overrides(load_config(args.lm_config), lm) if args.lm_config else None
    if lm_config is not None and lm_config.get("exp_dir") == config.get("exp_dir"):
        raise ValueError("lm_config exp_dir must differ from the base exp_dir: bin/train "
                         "would resume the base run's checkpoints instead of fine-tuning "
                         "from model_init")
    return config, lm_config


def _metrics_line(path: str, lines: List[str]) -> None:
    eer, mindcf = compute_metrics(path)
    line = f"{os.path.basename(path)}: EER {eer:.3f}% minDCF {mindcf:.4f}"
    print(line, flush=True)
    lines.append(line)


def run_stages(args: argparse.Namespace, config: Dict, stage: int, stop_stage: int,
               lm_config: Optional[Dict] = None, layout: Layout = VOXCELEB) -> Dict[int, Dict]:
    """Run stages [stage, stop_stage] on `layout`'s sets; returns {stage:
    {"s": seconds, "lines": printed result lines}}, and for stage 9 also
    "stages", the re-entered stages' own."""
    device = args.device
    train_set, eval_set = layout.train, layout.eval
    exp_dir = config["exp_dir"]
    models_dir = os.path.join(exp_dir, "models")
    avg_ckpt = os.path.join(exp_dir, "avg_model.pt")
    emb_dir = os.path.join(exp_dir, "embeddings")
    score_dir = os.path.join(exp_dir, "scores")
    mean_vec_path = os.path.join(emb_dir, f"{train_set}_mean.npy")
    cohort_path = os.path.join(emb_dir, f"{train_set}_spk_mean.npz")
    eval_emb = os.path.join(emb_dir, f"{eval_set}.npz")
    train_emb = os.path.join(emb_dir, f"{train_set}.npz")
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
        for dset in (train_set, eval_set):
            d = os.path.join(args.data_root, dset)
            if config.get("data_type", "shard") == "shard" and dset == train_set:
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
        for name, out in ((eval_set, eval_emb), (train_set, train_emb)):
            extract(config, os.path.join(args.data_root, name, "raw.list"), avg_ckpt, out,
                    device=device)
        end(4)

    if in_range(5):
        lines = begin(5, "cosine score + metrics")
        # the train-set mean vector, subtracted before scoring
        np.save(mean_vec_path, load_embeddings(train_emb)[1].mean(0))
        for f in score_trials(eval_emb, args.trials, score_dir, mean_vec_path, device=device):
            _metrics_line(f, lines)
        end(5)

    if in_range(6):
        lines = begin(6, "AS-Norm")
        vector_mean(train_emb, os.path.join(args.data_root, train_set, "utt2spk"), cohort_path)
        for trial in args.trials:
            base = os.path.join(score_dir, os.path.basename(trial) + ".score")
            normed = score_norm(base, base + ".asnorm", eval_emb,
                                cohort_path, method="asnorm", top_n=args.asnorm_top_n,
                                mean_vec_path=mean_vec_path, device=device)
            _metrics_line(normed, lines)
        end(6)

    if in_range(7):
        lines = begin(7, "QMF calibration")
        # trained on trials generated from the training set, never on the
        # evaluation trials (whose labels would leak into the calibrator)
        params, loss, n_cal = train_calibration_on_train_set(
            os.path.join(args.data_root, train_set), train_emb,
            cohort_path, mean_vec_path, exp_dir, score_dir, top_n=args.asnorm_top_n,
            each_trial_num=args.calibration_trial_num, device=device)
        print(f"  calibration trained on {n_cal} trials (Cllr {loss:.4f})", flush=True)
        dur_path = os.path.join(args.data_root, eval_set, "utt2dur")
        if not os.path.exists(dur_path):
            wav2dur(os.path.join(args.data_root, eval_set, "wav.scp"), dur_path)
        durations = load_durations(dur_path)
        for trial in args.trials:
            normed = os.path.join(score_dir, os.path.basename(trial) + ".score.asnorm")
            with open(normed) as f:
                factors, meta = gather_factors(list(f), durations)
            out = normed + ".qmf"
            write_calibrated(out, meta, apply_calibration(params, factors))
            _metrics_line(out, lines)
        end(7)

    if in_range(8):
        lines = begin(8, "export model bundle")
        out_dir = export_model(exp_dir, os.path.join(exp_dir, "exported"), checkpoint=avg_ckpt,
                               mean_vec=mean_vec_path if os.path.exists(mean_vec_path) else None)
        program = export_program(config, avg_ckpt, os.path.join(out_dir, "model.pt2"))
        line = f"  exported {out_dir} (+ {os.path.basename(program)})"
        print(line, flush=True)
        lines.append(line)
        end(8)

    if in_range(9):
        begin(9, "large-margin fine-tune (re-entering stages 3-8)")
        lm = dict(lm_config, model_init=avg_ckpt)
        done[9]["stages"] = run_stages(args, lm, 3, min(stop_stage, 8), layout=layout)
        end(9)
    return done


def run(args: argparse.Namespace, layout: Layout = VOXCELEB) -> Dict[int, Dict]:
    """The configs (checked before any stage), then the stages."""
    import logging

    import torch

    config, lm_config = load_configs(args)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run_stages(args, config, args.stage, args.stop_stage, lm_config, layout)


def main(argv: Optional[List[str]] = None) -> Dict[int, Dict]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
