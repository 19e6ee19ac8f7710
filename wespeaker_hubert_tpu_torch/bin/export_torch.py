"""Export a port checkpoint as a WeSpeaker (reference PyTorch) state_dict.

Counterpart of `wespeaker_hubert_tpu/bin/export_torch.py`:

    python -m wespeaker_hubert_tpu_torch.bin.export_torch \\
        --exp_dir exp/ResNet34... [--checkpoint path] \\
        [--ref_repo /path/to/wespeaker] --output exported.pt

The experiment directory holds the training config (`config.json`, as the
port's bin/train writes it, or a JAX run's `config.yaml`); the checkpoint is
`--checkpoint`, else its `avg_model.pt` / `avg_model.ckpt`, else the newest
`models/model_N.pt`, a port `.pt` or a JAX `.ckpt` (utils/checkpoint.py:
load_state).  The output is the backbone alone (no `frontend.` or
`projection.` keys), checked by a strict `load_state_dict` into the port's
module and written in its order, `num_batches_tracked` included: what
WeSpeaker's `model.load_state_dict(torch.load(out))` and its ONNX / JIT
exporters take.  With `--ref_repo` (a WeSpeaker checkout) the reference
module of the same name is built from it and the state_dict is also loaded
strictly into that, as the JAX tool checks its export.
"""

from __future__ import annotations

import argparse
import os
import sys
import types
from typing import Dict, Optional

import torch

from ..models.registry import get_speaker_model
from ..utils.checkpoint import latest_checkpoint, load_state
from ..utils.config import load_config

__all__ = ["export_torch", "exp_config", "exp_checkpoint", "backbone_state", "main"]


def exp_config(exp_dir: str) -> Dict:
    """The training config of a port (`config.json`) or JAX (`config.yaml`)
    experiment directory."""
    for name in ("config.json", "config.yaml"):
        path = os.path.join(exp_dir, name)
        if os.path.exists(path):
            return load_config(path)
    raise FileNotFoundError(f"no config.json or config.yaml under {exp_dir}")


def exp_checkpoint(exp_dir: str) -> str:
    """The averaged checkpoint of an experiment directory, else its newest
    epoch checkpoint."""
    for name in ("avg_model.pt", "avg_model.ckpt"):
        path = os.path.join(exp_dir, name)
        if os.path.exists(path):
            return path
    path = latest_checkpoint(os.path.join(exp_dir, "models"))
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {exp_dir}")
    return path


def backbone_state(config: Dict, checkpoint: str) -> Dict[str, torch.Tensor]:
    """The checkpoint's backbone tensors, checked strictly against the port's
    module of `config['model']`, in the module's order."""
    model_args = dict(config.get("model_args", {}))
    module = get_speaker_model(config["model"])(**model_args)
    state = load_state(checkpoint, config["model"], model_args.get("feat_dim", 80))
    sd = {k: v for k, v in state.items() if not k.startswith(("frontend.", "projection."))}
    module.load_state_dict(sd, strict=True)
    return {k: sd[k] for k in module.state_dict()}


def _reference_model(ref_repo: str, model: str, **model_args):
    """The reference WeSpeaker module of that name, built from a checkout."""
    if "wespeaker" not in sys.modules or not hasattr(sys.modules.get("wespeaker"), "__path__"):
        pkg = types.ModuleType("wespeaker")
        pkg.__path__ = [os.path.join(ref_repo, "wespeaker")]
        sys.modules["wespeaker"] = pkg
    if ref_repo not in sys.path:
        sys.path.insert(0, ref_repo)
    from wespeaker.models.speaker_model import get_speaker_model as ref_get_speaker_model

    return ref_get_speaker_model(model)(**model_args)


def export_torch(exp_dir: str, output: str, checkpoint: Optional[str] = None,
                 ref_repo: Optional[str] = None) -> str:
    """Write the WeSpeaker state_dict of the experiment's checkpoint to
    `output`; returns `output`."""
    config = exp_config(exp_dir)
    sd = backbone_state(config, checkpoint or exp_checkpoint(exp_dir))
    if ref_repo:
        ref = _reference_model(ref_repo, config["model"], **config.get("model_args", {}))
        ref.load_state_dict(sd, strict=True)
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    torch.save(sd, output)
    return output


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--ref_repo", default=None,
                   help="a WeSpeaker checkout: also check against its module")
    p.add_argument("--output", required=True, help="output .pt path")
    args = p.parse_args()
    out = export_torch(args.exp_dir, args.output, checkpoint=args.checkpoint,
                       ref_repo=args.ref_repo)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
