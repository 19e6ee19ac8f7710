"""CN-Celeb fine-tune from a DINO teacher on the port.

Counterpart of `examples/cnceleb/v3_finetune/run.py`, stages 2-6: an
averaged DINO teacher backbone (recipes/voxceleb_v3_dino.py, then
bin/average_model) initializes supervised ArcMargin training through
bin/train's `model_init` (the head starts fresh: utils/checkpoint.py:
load_partial), then the average / extract / score / AS-Norm chain of
recipes/voxceleb_v3_contrastive.py:run_stages over `DATA/cnceleb_train`
(the cohort) and `DATA/eval`:

    python -m wespeaker_hubert_tpu_torch.recipes.cnceleb_v3_finetune \\
        --stage 2 --stop_stage 6 --model_init exp/dino/avg_model.pt \\
        --data_root data [--config conf.yaml] [--trials A.lst B.lst] \\
        [--device cuda|cpu] [a.b.c=value ...]

`--config` defaults to `examples/cnceleb/v3_finetune/conf/ecapa_tdnn_ft.yaml`;
a trial name that is not a path is looked up under `DATA/eval/trials/`
(`CNC-Eval-Concat.lst` and `CNC-Eval-Avg.lst` by default).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

from ..bin.train import train
from ..utils.config import apply_overrides, load_config
from .voxceleb_v3_contrastive import EXAMPLES, run_stages

__all__ = ["parse_args", "trial_paths", "main"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stage", type=int, default=3)
    p.add_argument("--stop_stage", type=int, default=6)
    p.add_argument("--config",
                   default=str(EXAMPLES / "cnceleb/v3_finetune/conf/ecapa_tdnn_ft.yaml"))
    p.add_argument("--model_init", default=None,
                   help="averaged DINO teacher checkpoint (pretraining)")
    p.add_argument("--data_root", default="data")
    p.add_argument("--trials", nargs="+", default=["CNC-Eval-Concat.lst", "CNC-Eval-Avg.lst"])
    p.add_argument("--asnorm_top_n", type=int, default=300)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", help="a.b.c=value config overrides")
    return p.parse_args(argv)


def trial_paths(args: argparse.Namespace) -> List[str]:
    return [t if os.path.exists(t) else os.path.join(args.data_root, "eval", "trials", t)
            for t in args.trials]


def main(argv: Optional[List[str]] = None) -> Dict[int, Dict]:
    import logging

    import torch

    args = parse_args(argv)
    config = apply_overrides(load_config(args.config), args.overrides)
    if args.model_init:
        # the DINO checkpoint holds the backbone alone: the ArcMargin head
        # initializes fresh (bin/train's load_partial)
        config["model_init"] = args.model_init
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run_stages(args, config, train, "cnceleb_train", "eval", trial_paths(args),
                      "supervised fine-tune from the DINO initialization", num_avg_default=3)


if __name__ == "__main__":
    main()
