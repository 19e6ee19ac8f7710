"""The WavLM-frontend staged recipe on the port.

Counterpart of `examples/voxceleb/v2/run_wavlm.py` (WeSpeaker's
run_wavlm.sh stages), with the same arguments, directory names and printed
lines, each stage through the port's bin/train and bin/average_model on
`--device` (CUDA unless the caller asks for the CPU):

  1. frozen-frontend training: `s3prl_args.frozen` true, into
     `EXP-frozen`, the last `num_avg` (default 3) checkpoints averaged into
     `EXP-frozen/avg_model.pt`;
  2. joint fine-tune: the frontend unfrozen, `initial_lr` 1e-4,
     `joint_epochs` (default 10) epochs from stage 1's average, into
     `EXP-joint`, 2 checkpoints averaged;
  3. joint large-margin fine-tune: 600-frame chunks, no speed perturbation
     (the head shrinks from 3 x N classes to N: bin/train's `model_init`
     skips the mismatched `projection.weight`, so the head starts fresh),
     the margin fixed at 0.5 from epoch 1, `do_lm`, `initial_lr` 2e-5,
     `lmft_epochs` (default 3) epochs from stage 2's average, into
     `EXP-joint-lmft`, 1 checkpoint "averaged".

EXP is the config's `exp_dir`.  Every stage derives its config from the one
`--config` (the frozen YAML), as the JAX driver does: the joint and lmft
YAMLs are not read.

    python -m wespeaker_hubert_tpu_torch.recipes.voxceleb_v2_wavlm \\
        --config examples/voxceleb/v2/conf/ecapa_tdnn_wavlm_frozen.yaml \\
        [--stage 1] [--stop_stage 3] [--device cuda|cpu] [a.b.c=value ...]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

from ..bin.average_model import average_model
from ..bin.train import train
from ..utils.config import apply_overrides, load_config

__all__ = ["parse_args", "stage_dir", "stage_configs", "run_stages", "main"]

# stage -> (exp_dir suffix, printed line, checkpoints averaged)
STAGES = {
    1: ("frozen", "stage 1: frozen-frontend training", None),
    2: ("joint", "stage 2: joint fine-tune (frontend unfrozen, low LR)", 2),
    3: ("joint-lmft", "stage 3: joint large-margin fine-tune", 1),
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="conf/ecapa_tdnn_wavlm_frozen.yaml")
    p.add_argument("--stage", type=int, default=1)
    p.add_argument("--stop_stage", type=int, default=3)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", help="a.b.c=value config overrides")
    return p.parse_args(argv)


def stage_dir(base: Dict, stage: int) -> str:
    return base["exp_dir"] + "-" + STAGES[stage][0]


def stage_configs(base: Dict) -> Dict[int, Dict]:
    """The training config of each stage, derived from `base` as
    run_wavlm.py derives it (shallow copies: a replaced section is a new
    dict, the others are base's)."""
    def derived(stage: int, frozen: bool) -> Dict:
        cfg = dict(base, exp_dir=stage_dir(base, stage))
        cfg["dataset_args"] = dict(base["dataset_args"])
        cfg["dataset_args"]["s3prl_args"] = {**base["dataset_args"]["s3prl_args"],
                                             "frozen": frozen}
        if stage > 1:
            cfg["model_init"] = os.path.join(stage_dir(base, stage - 1), "avg_model.pt")
        return cfg

    frozen = derived(1, True)
    joint = derived(2, False)
    joint["scheduler_args"] = {**base.get("scheduler_args", {}), "initial_lr": 1e-4}
    joint["num_epochs"] = base.get("joint_epochs", 10)
    lmft = derived(3, False)
    lmft["dataset_args"]["num_frms"] = 600
    lmft["dataset_args"]["speed_perturb"] = False
    lmft["margin_update"] = {"initial_margin": 0.5, "final_margin": 0.5,
                             "increase_start_epoch": 1, "fix_start_epoch": 1}
    lmft["projection_args"] = {**base.get("projection_args", {}), "do_lm": True}
    lmft["scheduler_args"] = {**base.get("scheduler_args", {}), "initial_lr": 2e-5}
    lmft["num_epochs"] = base.get("lmft_epochs", 3)
    return {1: frozen, 2: joint, 3: lmft}


def run_stages(base: Dict, stage: int, stop_stage: int, device="cuda") -> Dict[int, Dict]:
    """Run stages [stage, stop_stage] of the recipe on `base`; returns
    {stage: {"s": seconds, "exp_dir", "avg_model"}}."""
    configs = stage_configs(base)
    done: Dict[int, Dict] = {}
    for s in range(max(stage, 1), min(stop_stage, 3) + 1):
        cfg = configs[s]
        print(STAGES[s][1], flush=True)
        t0 = time.perf_counter()
        train(cfg, device=device)
        avg = os.path.join(cfg["exp_dir"], "avg_model.pt")
        average_model(os.path.join(cfg["exp_dir"], "models"), avg,
                      num=STAGES[s][2] or base.get("num_avg", 3))
        done[s] = {"s": time.perf_counter() - t0, "exp_dir": cfg["exp_dir"], "avg_model": avg}
    return done


def main(argv: Optional[List[str]] = None) -> Dict[int, Dict]:
    import logging

    import torch

    args = parse_args(argv)
    base = apply_overrides(load_config(args.config), args.overrides)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run_stages(base, args.stage, args.stop_stage, device=args.device)


if __name__ == "__main__":
    main()
