"""VoxCeleb DINO self-supervised recipe on the port.

Counterpart of `examples/voxceleb/v3/dino/run.py`, with its arguments and
`--device` (CUDA unless the caller asks for the CPU): multi-crop DINO
pretraining of a speaker backbone without labels (2 x 200-frame global and
4 x 100-frame local crops, `aug_prob` 0.6, 80-mel dithered fbank, the
65,536-way head of 2,048 hidden and 256 bottleneck units, SGD with momentum
0.9, LR base_lr x batch / 256 cosine to 1e-5 after 10 warmup epochs, weight
decay 1e-4, teacher momentum 0.996 -> 1, teacher temperature 0.04 -> 0.07
over the first 20% of the steps, the last layer frozen for one epoch),
saving the teacher backbone after every epoch as `EXP/models/model_N.pt`:

    python -m wespeaker_hubert_tpu_torch.recipes.voxceleb_v3_dino \\
        --train_data data/vox2_dev/raw.list --exp_dir exp/dino \\
        [--model ECAPA_TDNN_c1024] [--noise_store S] [--reverb_store S] \\
        [--enable_amp] [--device cuda|cpu]

It runs bin/train_dino.py on the config `dino_config` builds from the
arguments.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from ..bin.train_dino import train_dino
from ..ssl import DINOState

__all__ = ["parse_args", "dino_config", "main"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train_data", required=True)
    p.add_argument("--exp_dir", default="exp/dino_ecapa_c512")
    p.add_argument("--model", default="ECAPA_TDNN_c1024")
    p.add_argument("--embed_dim", type=int, default=192)
    p.add_argument("--num_epochs", type=int, default=150)
    p.add_argument("--epoch_iter", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--base_lr", type=float, default=0.2)
    p.add_argument("--out_dim", type=int, default=65536)
    p.add_argument("--noise_store", default=None)
    p.add_argument("--reverb_store", default=None)
    p.add_argument("--enable_amp", action="store_true", help="bf16 forwards and backward")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def dino_config(args: argparse.Namespace) -> Dict:
    """bin/train_dino's config for run.py's settings; the rest are its
    defaults, which are run.py's too."""
    return {
        "exp_dir": args.exp_dir,
        "train_data": args.train_data,
        "model": args.model,
        "model_args": {"feat_dim": 80, "embed_dim": args.embed_dim},
        "num_epochs": args.num_epochs,
        "epoch_iter": args.epoch_iter,
        "save_epoch_interval": 1,
        "compute_dtype": "bf16" if args.enable_amp else "f32",
        "dataloader_args": {"batch_size": args.batch_size},
        "dataset_args": {"reverb_data": args.reverb_store, "noise_data": args.noise_store,
                         "fbank_args": {"num_mel_bins": 80, "dither": 1.0}},
        "dino_args": {"out_dim": args.out_dim},
        "scheduler_args": {"base_lr": args.base_lr},
        "optimizer": "SGD",
    }


def main(argv: Optional[List[str]] = None) -> DINOState:
    import logging

    import torch

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return train_dino(dino_config(args), device=args.device)


if __name__ == "__main__":
    main()
