"""CN-Celeb supervised speaker-verification recipe on the port.

Counterpart of `examples/cnceleb/v2/run.py`, stages 1-9, with the same
arguments (and `--device`, CUDA unless the caller asks for the CPU, and
`a.b.c=value` / `lm.a.b.c=value` overrides), each stage through
`recipes/voxceleb_v2.py`'s stage code on CN-Celeb's sets:

  1. aug stores from `DATA/musan/wav.scp` and `DATA/rirs/wav.scp`;
  2. tar shards + `shard.list` of `DATA/cnceleb_train` (with `data_type:
     shard`), and `raw.list` of `cnceleb_train` and `eval`;
  3. training (bin/train.py; `dataloader_args.num_workers` picks the C++
     loader, as the config's 8 do);
  4. checkpoint averaging and extraction of `eval` and `cnceleb_train`;
  5. cosine scores of each trial list, the `cnceleb_train` mean vector
     subtracted;
  6. AS-Norm with the `cnceleb_train` speaker-mean cohort;
  7. QMF calibration trained on `--calibration_trial_num` trials drawn from
     `cnceleb_train`, applied to each AS-Norm file;
  8. export: `EXP/exported` and its `torch.export` program;
  9. the large-margin fine-tune: stages 3-8 again with `--lm_config`.

`--trials` names files that exist, or names under `DATA/eval/trials/`: by
default `CNC-Eval-Concat.lst` (the concatenated enrollments) and
`CNC-Eval-Avg.lst` (the averaged ones); both are scored against the `eval`
embeddings, so `eval` holds every enrollment key both lists name, as the
reference's data preparation leaves it.

    python -m wespeaker_hubert_tpu_torch.recipes.cnceleb_v2 --stage 1 \\
        --stop_stage 9 --config examples/cnceleb/v2/conf/resnet34.yaml \\
        --lm_config LM.yaml --data_root data [--device cuda|cpu] \\
        [a.b.c=value ...] [lm.a.b.c=value ...]
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from .voxceleb_v2 import Layout, parse_args, run

__all__ = ["CNCELEB", "TRIALS", "main"]

CNCELEB = Layout(train="cnceleb_train", eval="eval")
TRIALS = ["CNC-Eval-Concat.lst", "CNC-Eval-Avg.lst"]


def main(argv: Optional[List[str]] = None) -> Dict[int, Dict]:
    args = parse_args(argv, description=__doc__, config="conf/resnet34.yaml", trials=TRIALS,
                      calibration_trial_num=20000)
    args.trials = [t if os.path.exists(t) else os.path.join(args.data_root, "eval", "trials", t)
                   for t in args.trials]
    return run(args, CNCELEB)


if __name__ == "__main__":
    main()
