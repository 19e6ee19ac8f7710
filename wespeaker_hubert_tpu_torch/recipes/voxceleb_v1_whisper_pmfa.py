"""Whisper-PMFA speaker-verification recipe on the port.

Counterpart of `examples/voxceleb/v1/Whisper-PMFA/run.py`, stages 2-7, with
its arguments, file layout and printed lines, each stage through the port's
own bin modules on `--device` (CUDA unless the caller asks for the CPU):

  2. data lists: `raw.list` of `DATA/vox1_dev` and `DATA/vox1`;
  3. the PMFA head trained on the FROZEN Whisper encoder
     (`--stage0_config`, conf/whisper_pmfa_stage0.yaml);
  4. joint fine-tuning with the encoder unfrozen (`--stage1_config`), its
     `model_init` the latest checkpoint of stage 3;
  5. checkpoint averaging (`EXP1/avg_model.pt`) and extraction of both raw
     lists (`EXP1/embeddings/{vox1,vox1_dev}.npz`);
  6. cosine scores of each trial file after subtracting the `vox1_dev` mean,
     and their EER / minDCF;
  7. AS-Norm over the `vox1_dev` speaker means (`*.score.asnorm`).

    python -m wespeaker_hubert_tpu_torch.recipes.voxceleb_v1_whisper_pmfa \\
        --stage 2 --stop_stage 7 \\
        --stage0_config examples/voxceleb/v1/Whisper-PMFA/conf/whisper_pmfa_stage0.yaml \\
        --stage1_config examples/voxceleb/v1/Whisper-PMFA/conf/whisper_pmfa_stage1.yaml \\
        --data_root data --trials data/vox1/trials.kaldi [--device cuda|cpu] \\
        [a.b.c=value ...] [stage0.a.b.c=value ...] [stage1.a.b.c=value ...]

`a.b.c=value` overrides apply to both configs, `stage0.`- and
`stage1.`-prefixed ones to that config alone (utils/config.py).  The two
`exp_dir`s must differ (else stage 4 would resume stage 3's checkpoints
instead of starting from `model_init`): it is checked before any stage
runs, and so is a config's `pipeline_parallel` or `sequence_parallel`
(whisper_pmfa_stage1_pp.yaml asks for 4 pipeline stages), which the port
refuses (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..bin.average_model import average_model
from ..bin.extract import extract
from ..bin.score import score_norm, score_trials
from ..bin.tools import make_raw_list, vector_mean
from ..bin.train import train
from ..models.speaker_net import refuse_model_parallel
from ..utils.checkpoint import latest_checkpoint
from ..utils.config import apply_overrides, load_config
from ..utils.embeddings import load_embeddings
from .voxceleb_v2 import _metrics_line

__all__ = ["parse_args", "load_configs", "run_stages", "main"]

PREFIXES = ("stage0.", "stage1.")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stage", type=int, default=3)
    p.add_argument("--stop_stage", type=int, default=7)
    p.add_argument("--stage0_config", default="conf/whisper_pmfa_stage0.yaml")
    p.add_argument("--stage1_config", default="conf/whisper_pmfa_stage1.yaml")
    p.add_argument("--data_root", default="data")
    p.add_argument("--trials", nargs="+", default=[])
    p.add_argument("--asnorm_top_n", type=int, default=300)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*",
                   help="a.b.c=value overrides of both configs, stage0.a.b.c=value / "
                        "stage1.a.b.c=value of one")
    return p.parse_args(argv)


def load_configs(args: argparse.Namespace) -> Tuple[Dict, Dict]:
    """The stage-0 and stage-1 configs, each with its overrides; raises if
    they share an `exp_dir` or ask for pipeline or sequence parallelism."""
    both = [o for o in args.overrides if not o.startswith(PREFIXES)]
    configs = []
    for prefix, path in zip(PREFIXES, (args.stage0_config, args.stage1_config)):
        own = [o[len(prefix):] for o in args.overrides if o.startswith(prefix)]
        configs.append(apply_overrides(load_config(path), both + own))
    for cfg in configs:  # before hours of stage 3, not at stage 4
        refuse_model_parallel(cfg.get("dataset_args", {}).get("whisper_encoder_args", {}))
    if configs[0].get("exp_dir") == configs[1].get("exp_dir"):
        raise ValueError("the stage-0 and stage-1 exp_dirs must differ: stage 4 would resume "
                         "stage 3's checkpoints instead of starting from model_init")
    return configs[0], configs[1]


def run_stages(args: argparse.Namespace, cfg0: Dict, cfg1: Dict, stage: int,
               stop_stage: int) -> Dict[int, Dict]:
    """Run stages [stage, stop_stage]; returns {stage: {"s": seconds,
    "lines": printed result lines}}."""
    device = args.device
    exp_dir = cfg1["exp_dir"]
    models_dir = os.path.join(exp_dir, "models")
    avg_ckpt = os.path.join(exp_dir, "avg_model.pt")
    emb_dir = os.path.join(exp_dir, "embeddings")
    score_dir = os.path.join(exp_dir, "scores")
    mean_vec_path = os.path.join(emb_dir, "vox1_dev_mean.npy")
    done: Dict[int, Dict] = {}

    def begin(s: int, what: str):
        print(f"stage {s}: {what}", flush=True)
        done[s] = {"lines": [], "t0": time.perf_counter()}
        return done[s]["lines"]

    def end(s: int):
        done[s]["s"] = time.perf_counter() - done[s].pop("t0")

    def in_range(s: int) -> bool:
        return stage <= s <= stop_stage

    if in_range(2):
        begin(2, "data lists")
        for dset in ("vox1_dev", "vox1"):
            d = os.path.join(args.data_root, dset)
            make_raw_list(os.path.join(d, "wav.scp"), os.path.join(d, "utt2spk"),
                          os.path.join(d, "raw.list"))
        end(2)

    if in_range(3):
        begin(3, "PMFA head training, whisper encoder FROZEN")
        train(cfg0, device=device)
        end(3)

    if in_range(4):
        begin(4, "joint fine-tune, whisper encoder unfrozen")
        init = latest_checkpoint(os.path.join(cfg0["exp_dir"], "models"))
        if not init:
            raise FileNotFoundError(f"no stage-0 checkpoint under {cfg0['exp_dir']}")
        train(dict(cfg1, model_init=init), device=device)
        end(4)

    if in_range(5):
        begin(5, "average + extract")
        average_model(models_dir, avg_ckpt, num=cfg1.get("num_avg", 1))
        for name in ("vox1", "vox1_dev"):
            extract(cfg1, os.path.join(args.data_root, name, "raw.list"), avg_ckpt,
                    os.path.join(emb_dir, f"{name}.npz"), device=device)
        end(5)

    if in_range(6):
        lines = begin(6, "cosine score (sub mean of vox1_dev) + metrics")
        _, cohort_emb = load_embeddings(os.path.join(emb_dir, "vox1_dev.npz"))
        np.save(mean_vec_path, cohort_emb.mean(0))
        for f in score_trials(os.path.join(emb_dir, "vox1.npz"), args.trials, score_dir,
                              mean_vec_path, device=device):
            _metrics_line(f, lines)
        end(6)

    if in_range(7):
        lines = begin(7, "AS-Norm")
        cohort_path = os.path.join(emb_dir, "vox1_dev_spk_mean.npz")
        vector_mean(os.path.join(emb_dir, "vox1_dev.npz"),
                    os.path.join(args.data_root, "vox1_dev", "utt2spk"), cohort_path)
        for trial in args.trials:
            base = os.path.join(score_dir, os.path.basename(trial) + ".score")
            normed = score_norm(base, base + ".asnorm", os.path.join(emb_dir, "vox1.npz"),
                                cohort_path, method="asnorm", top_n=args.asnorm_top_n,
                                mean_vec_path=mean_vec_path, device=device)
            _metrics_line(normed, lines)
        end(7)
    return done


def main(argv: Optional[List[str]] = None) -> Dict[int, Dict]:
    import logging

    import torch

    args = parse_args(argv)
    cfg0, cfg1 = load_configs(args)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run_stages(args, cfg0, cfg1, args.stage, args.stop_stage)


if __name__ == "__main__":
    main()
