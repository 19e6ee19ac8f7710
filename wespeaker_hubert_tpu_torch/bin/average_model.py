"""Checkpoint averaging: the last `num` epoch checkpoints -> one state_dict.

Counterpart of `wespeaker_hubert_tpu/bin/average_model.py`:

    python -m wespeaker_hubert_tpu_torch.bin.average_model \\
        --src_dir exp/models --dst_model exp/avg_model.pt [--num 10] \\
        [--min_epoch 0] [--max_epoch 65536]

The sources are bin/train's `model_N.pt`; the result loads into bin/extract
and bin/serve as they do.
"""

from __future__ import annotations

import os
import re

from ..utils.checkpoint import average_checkpoints, save_checkpoint

__all__ = ["average_model", "main"]


def average_model(model_dir: str, dst: str, num: int = 10, min_epoch: int = 0,
                  max_epoch: int = 65536) -> str:
    """Average the last `num` `model_N.pt` with N in [min_epoch, max_epoch]
    into `dst` (with a JSON sidecar naming the sources); returns `dst`."""
    rx = re.compile(r"model_(\d+)\.pt")
    found = []
    for name in os.listdir(model_dir):
        m = rx.fullmatch(name)
        if m and min_epoch <= int(m.group(1)) <= max_epoch:
            found.append((int(m.group(1)), os.path.join(model_dir, name)))
    found.sort()
    paths = [p for _, p in found[-num:]]
    if not paths:
        raise FileNotFoundError(f"no model_N.pt in {model_dir} with N in [{min_epoch}, "
                                f"{max_epoch}]")
    save_checkpoint(dst, average_checkpoints(paths), meta={"averaged_from": paths})
    return dst


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src_dir", required=True)
    p.add_argument("--dst_model", required=True)
    p.add_argument("--num", type=int, default=10)
    p.add_argument("--min_epoch", type=int, default=0)
    p.add_argument("--max_epoch", type=int, default=65536)
    args = p.parse_args()
    average_model(args.src_dir, args.dst_model, args.num, args.min_epoch, args.max_epoch)


if __name__ == "__main__":
    main()
