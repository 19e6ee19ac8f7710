"""Import a WeSpeaker (reference PyTorch) checkpoint as a port checkpoint.

Counterpart of `wespeaker_hubert_tpu/bin/import_torch.py`, with its CLI:

    python -m wespeaker_hubert_tpu_torch.bin.import_torch \\
        --model ResNet34 --torch_ckpt avg_model.pt --output models/resnet34.pt \\
        embed_dim=256 [feat_dim=80] [two_emb_layer=true] [pooling_func=TSTP]

The checkpoint may be a bare state_dict or hold one under `state_dict` or
`model`; `module.` prefixes are stripped and the margin head
(`projection.*`, training-only state) dropped.  The port's modules carry
WeSpeaker's names and shapes, so there is nothing to convert: every key and
shape is checked by a strict `load_state_dict` into the port's module of
that name (built from the `key=value` model_args; `embed_dim` has no
default), and the checkpoint's own tensors are written, in the module's
order, as a port checkpoint (utils/checkpoint.py) that bin/extract,
bin/train's `model_init` and bin/serve's model directory load.

One exception is refused: a 2-D backbone (ResNet and the FrameMapNet
family, RepVGG) with a multi-head pooling (MHASTP, MQMHASTP).  The port
flattens that frame map frequency-major, as the JAX package does, where
WeSpeaker flattens it channel-major; the names and shapes match, so such a
checkpoint would load and embed wrongly.
"""

from __future__ import annotations

import logging
import sys
from typing import Dict

import torch

from ..models.pooling import MULTI_HEAD_POOLINGS
from ..models.registry import get_speaker_model
from ..models.repvgg import RepVGG
from ..models.resnet import FrameMapNet
from ..utils.checkpoint import save_checkpoint
from ..utils.config import coerce_value

__all__ = ["import_torch", "read_wespeaker_state_dict", "main"]

logger = logging.getLogger("import_torch")


def read_wespeaker_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A WeSpeaker `.pt`'s backbone state_dict: unwrapped from
    `state_dict` / `model`, without `module.` prefixes or `projection.*`."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    sd = {}
    for k, v in obj.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not k.startswith("projection."):
            sd[k] = v
    return sd


def import_torch(model: str, torch_ckpt: str, output: str, **model_args) -> str:
    """Check the WeSpeaker checkpoint at `torch_ckpt` against the port's
    `model` module and write it to `output`; returns `output`."""
    if "embed_dim" not in model_args:
        raise ValueError("embed_dim=N is needed to build the port's module")
    model_args.setdefault("feat_dim", 80)
    module = get_speaker_model(model)(**model_args)
    if isinstance(module, (FrameMapNet, RepVGG)) and module.pooling_func in MULTI_HEAD_POOLINGS:
        raise ValueError(
            f"{model} with {module.pooling_func}: the port flattens the frame map "
            "frequency-major for a multi-head pooling (the JAX package's order), WeSpeaker "
            "channel-major, so a WeSpeaker checkpoint of it would load and embed wrongly")
    sd = read_wespeaker_state_dict(torch_ckpt)
    module.load_state_dict(sd, strict=True)  # every key and shape, before writing
    state = {k: sd[k] for k in module.state_dict()}
    save_checkpoint(output, state, meta={"source": torch_ckpt, "model": model,
                                         "model_args": model_args})
    n = sum(v.numel() for k, v in state.items() if v.is_floating_point())
    logger.info("imported %s: %d values -> %s", model, n, output)
    return output


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", required=True)
    p.add_argument("--torch_ckpt", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("overrides", nargs="*", help="model_args key=value")
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)
    model_args = {}
    for ov in args.overrides:
        if "=" not in ov:
            sys.exit(f"bad override {ov!r}: expected key=value")
        k, v = ov.split("=", 1)
        model_args[k] = coerce_value(v)
    import_torch(args.model, args.torch_ckpt, args.output, **model_args)


if __name__ == "__main__":
    main()
