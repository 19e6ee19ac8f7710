"""VoxCeleb MoCo / SimCLR self-supervised recipe on the port.

Counterpart of `examples/voxceleb/v3/contrastive_runner.py` (the MoCo and
SimCLR `run.py`), stages 2-6, with the same arguments, file layout and
printed lines, each stage through the port's own bin modules on `--device`
(CUDA unless the caller asks for the CPU):

  2. data lists: `raw.list` of `DATA/vox2_dev` and `DATA/vox1` (no labels
     are needed for training);
  3. training (bin/train_contrastive.py);
  4. checkpoint averaging (`EXP/avg_model.pt`) and extraction of both raw
     lists with the encoder's backbone (`EXP/embeddings/{vox1,vox2_dev}.npz`);
  5. the vox2_dev mean vector, cosine scores of each trial file and their
     EER / minDCF;
  6. the speaker-mean cohort and AS-Norm (`*.score.asnorm`).

    python -m wespeaker_hubert_tpu_torch.recipes.voxceleb_v3_contrastive \\
        --method moco --stage 2 --stop_stage 6 --data_root data \\
        --trials data/vox1/trials/vox1_O_cleaned.kaldi [--config conf.yaml] \\
        [--device cuda|cpu] [a.b.c=value ...]

`--config` defaults to `examples/voxceleb/v3/{method}/conf/ecapa_tdnn.yaml`;
its `ssl_method` must be `--method`.  `run_stages` is shared with the
CN-Celeb fine-tune recipe, whose stages differ only in the training call
and the set names.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from ..bin.average_model import average_model
from ..bin.extract import extract
from ..bin.score import score_norm, score_trials
from ..bin.tools import make_raw_list, vector_mean
from ..bin.train_contrastive import train_contrastive
from ..utils.config import apply_overrides, load_config
from ..utils.embeddings import load_embeddings
from .voxceleb_v2 import _metrics_line

__all__ = ["parse_args", "load_method_config", "run_stages", "main"]

EXAMPLES = Path(__file__).resolve().parents[2] / "examples"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--method", required=True, choices=("moco", "simclr"))
    p.add_argument("--stage", type=int, default=3)
    p.add_argument("--stop_stage", type=int, default=6)
    p.add_argument("--config", default=None,
                   help="default: examples/voxceleb/v3/{method}/conf/ecapa_tdnn.yaml")
    p.add_argument("--data_root", default="data")
    p.add_argument("--trials", nargs="+", default=[])
    p.add_argument("--asnorm_top_n", type=int, default=300)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", help="a.b.c=value config overrides")
    return p.parse_args(argv)


def load_method_config(args: argparse.Namespace) -> Dict:
    """The method's config with its overrides; `ssl_method` defaults to
    `--method` and must equal it."""
    path = args.config or str(EXAMPLES / "voxceleb/v3" / args.method / "conf/ecapa_tdnn.yaml")
    config = apply_overrides(load_config(path), args.overrides)
    config.setdefault("ssl_method", args.method)
    if config["ssl_method"] != args.method:
        raise ValueError(f"the config's ssl_method {config['ssl_method']!r} is not "
                         f"--method {args.method!r}")
    return config


def run_stages(args: argparse.Namespace, config: Dict, train_fn: Callable, train_set: str,
               eval_set: str, trials: List[str], train_what: str,
               num_avg_default: int = 10) -> Dict[int, Dict]:
    """Stages [args.stage, args.stop_stage] of 2-6 (module doc) over the
    sets `train_set` (the cohort) and `eval_set` under `args.data_root`;
    stage 3 calls `train_fn(config, device=...)`.  Returns {stage: {"s":
    seconds, "lines": printed result lines}}."""
    device = args.device
    exp_dir = config["exp_dir"]
    avg_ckpt = os.path.join(exp_dir, "avg_model.pt")
    emb_dir = os.path.join(exp_dir, "embeddings")
    score_dir = os.path.join(exp_dir, "scores")
    mean_vec_path = os.path.join(emb_dir, f"{train_set}_mean.npy")
    cohort_path = os.path.join(emb_dir, f"{train_set}_spk_mean.npz")
    eval_emb = os.path.join(emb_dir, f"{eval_set}.npz")
    done: Dict[int, Dict] = {}

    def begin(s: int, what: str) -> List[str]:
        print(f"stage {s}: {what}", flush=True)
        done[s] = {"lines": [], "t0": time.perf_counter()}
        return done[s]["lines"]

    def end(s: int) -> None:
        done[s]["s"] = time.perf_counter() - done[s].pop("t0")

    def in_range(s: int) -> bool:
        return args.stage <= s <= args.stop_stage

    if in_range(2):
        begin(2, "data lists")
        for dset in (train_set, eval_set):
            d = os.path.join(args.data_root, dset)
            make_raw_list(os.path.join(d, "wav.scp"), os.path.join(d, "utt2spk"),
                          os.path.join(d, "raw.list"))
        end(2)

    if in_range(3):
        begin(3, train_what)
        train_fn(config, device=device)
        end(3)

    if in_range(4):
        begin(4, "average + extract")
        average_model(os.path.join(exp_dir, "models"), avg_ckpt,
                      num=config.get("num_avg", num_avg_default))
        for name in (eval_set, train_set):
            extract(config, os.path.join(args.data_root, name, "raw.list"), avg_ckpt,
                    os.path.join(emb_dir, f"{name}.npz"), device=device)
        end(4)

    if in_range(5):
        lines = begin(5, "cosine score + metrics")
        _, cohort_emb = load_embeddings(os.path.join(emb_dir, f"{train_set}.npz"))
        np.save(mean_vec_path, cohort_emb.mean(0))
        for f in score_trials(eval_emb, trials, score_dir, mean_vec_path, device=device):
            _metrics_line(f, lines)
        end(5)

    if in_range(6):
        lines = begin(6, "AS-Norm")
        vector_mean(os.path.join(emb_dir, f"{train_set}.npz"),
                    os.path.join(args.data_root, train_set, "utt2spk"), cohort_path)
        for trial in trials:
            base = os.path.join(score_dir, os.path.basename(trial) + ".score")
            normed = score_norm(base, base + ".asnorm", eval_emb, cohort_path, method="asnorm",
                                top_n=args.asnorm_top_n, mean_vec_path=mean_vec_path,
                                device=device)
            _metrics_line(normed, lines)
        end(6)
    return done


def main(argv: Optional[List[str]] = None) -> Dict[int, Dict]:
    import logging

    import torch

    args = parse_args(argv)
    config = load_method_config(args)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run_stages(args, config, train_contrastive, "vox2_dev", "vox1", args.trials,
                      f"{args.method} self-supervised training")


if __name__ == "__main__":
    main()
