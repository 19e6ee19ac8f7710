"""Model export: a deployable model directory and a serialized graph.

Counterpart of `wespeaker_hubert_tpu/bin/export_model.py`:

    python -m wespeaker_hubert_tpu_torch.bin.export_model --exp_dir EXP \\
        --output_dir EXP/exported [--checkpoint path] [--mean_vec mean.npy] \\
        [--dtype bf16] [--program]

`export_model` writes the port's model directory, which `cli.speaker.Speaker`
and `bin/serve` load: `config.json` (the training config), `avg_model.pt`
(the checkpoint's state_dict in the port's names) and, given one,
`mean_vec.npy` (a sidecar, as in the JAX package; scoring subtracts it).
`dtype="bf16"` casts the floating tensors to bfloat16 and sets
`compute_dtype: bf16`, so bin/extract runs the model in bf16.  The
experiment directory may be the port's (`config.json`, `avg_model.pt`) or a
JAX run's (`config.yaml`, `avg_model.ckpt`, flax msgpack): this is also the
converter from a JAX model directory to the port's.

`export_program` plays the role of the JAX package's `export_stablehlo`
(and of WeSpeaker's ONNX export): the feats -> embedding function, without
a mask, as a `torch.export` program (`torch.export.save`) with symbolic
batch and time dims, time at least `MIN_FRAMES`.  It is traced on the CPU;
`load_program` reads it back onto a device.  The last trace is kept in the
process: a later export of the same model and model_args (a recipe's
stage 9 re-entering stage 8 with the fine-tuned weights) takes its graph
and binds the new weights and statistics, as a new trace would hold them.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import torch

from ..models.speaker_net import build_speaker_net, load_speaker_state
from ..utils.checkpoint import load_state, save_checkpoint
from .export_torch import exp_checkpoint, exp_config

__all__ = ["export_model", "export_program", "load_program", "MIN_FRAMES", "main"]

# three stride-2 stages leave ceil(T / 8) frames for the pooling; the trace
# needs two or more (a 1-frame map would be a special case of its shapes)
MIN_FRAMES = 16
# (model, model_args) -> the last program traced of them
_TRACED: Dict[str, "torch.export.ExportedProgram"] = {}


def export_model(exp_dir: str, output_dir: str, checkpoint: Optional[str] = None,
                 mean_vec: Optional[str] = None, dtype: Optional[str] = None) -> str:
    """Write `output_dir` (config.json + avg_model.pt [+ mean_vec.npy]) from
    the experiment at `exp_dir`; returns `output_dir`."""
    if dtype not in (None, "bf16"):
        raise ValueError(f"unsupported export dtype {dtype!r}")
    config = exp_config(exp_dir)
    state = load_state(checkpoint or exp_checkpoint(exp_dir), config["model"],
                       config.get("model_args", {}).get("feat_dim", 80))
    if dtype == "bf16":
        config["compute_dtype"] = dtype
        state = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                 for k, v in state.items()}
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=1, default=str)
    save_checkpoint(os.path.join(output_dir, "avg_model.pt"), state)
    if mean_vec:
        shutil.copy(mean_vec, os.path.join(output_dir, "mean_vec.npy"))
    return output_dir


class _Embed(torch.nn.Module):
    """feats (B, T, F) -> embedding (B, D): the SpeakerNet's `embed`."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.net.embed(feats)


def export_program(config: Dict, checkpoint: str, path: str) -> str:
    """Serialize the model's feats -> embedding function at `path` (a
    `torch.export` program, float32, symbolic batch and time); returns
    `path`.  The checkpoint must hold every backbone weight."""
    net = build_speaker_net(config)
    feat_dim = config.get("model_args", {}).get("feat_dim", 80)
    missing, _ = load_speaker_state(net, load_state(checkpoint, config["model"], feat_dim))
    missing = [k for k in missing if not k.startswith("frontend.")]
    if missing:
        raise KeyError(f"{checkpoint} lacks backbone weights: {missing[:8]}")
    if net.frontend is not None:
        raise NotImplementedError("export_program takes features: an SSL frontend's model "
                                  "takes the wav")
    module = _Embed(net.float().eval())
    key = json.dumps([config["model"], config.get("model_args", {})], sort_keys=True,
                     default=str)
    program = _TRACED.get(key)
    if program is None or not _rebind(program, module):
        batch = torch.export.Dim("batch", min=1, max=4096)
        time = torch.export.Dim("time", min=MIN_FRAMES, max=1 << 20)
        example = torch.zeros(2, 200, feat_dim)
        with torch.no_grad():
            # facts about the stride-2 stages' ceil-divided lengths that hold
            # for every T but that the shape solver cannot prove (ResNet's
            # flatten asks min(T', F' T') == T') are checked when it runs
            program = torch.export.export(module, (example,),
                                          dynamic_shapes={"feats": {0: batch, 1: time}},
                                          prefer_deferred_runtime_asserts_over_guards=True)
        _TRACED.clear()
        _TRACED[key] = program
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    return path


def _rebind(program: "torch.export.ExportedProgram", module: torch.nn.Module) -> bool:
    """Put `module`'s weights and statistics into a program traced of a
    module of the same structure; False (nothing changed) where the names,
    shapes or dtypes differ, or where a buffer the trace holds as a
    constant (a non-persistent one) is not the module's."""
    state, held = module.state_dict(), program.state_dict
    if set(state) != set(held) or any(
            state[k].shape != held[k].shape or state[k].dtype != held[k].dtype for k in state):
        return False
    buffers = dict(module.named_buffers())
    if any(k in buffers and not torch.equal(v, buffers[k]) for k, v in program.constants.items()):
        return False
    for k, v in state.items():
        v = v.detach().clone()
        held[k] = (torch.nn.Parameter(v, requires_grad=held[k].requires_grad)
                   if isinstance(held[k], torch.nn.Parameter) else v)
    return True


def load_program(path: str, device="cpu") -> torch.nn.Module:
    """The program `export_program` wrote, as a callable module on `device`."""
    program = torch.export.load(path)
    if torch.device(device).type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, torch.device(device))
    return program.module()


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--mean_vec", default=None)
    p.add_argument("--program", action="store_true",
                   help="also write model.pt2, the feats -> embedding torch.export program")
    p.add_argument("--dtype", default=None, choices=["bf16"],
                   help="cast the floating tensors to bfloat16")
    args = p.parse_args()
    out = export_model(args.exp_dir, args.output_dir, args.checkpoint, args.mean_vec,
                       dtype=args.dtype)
    if args.program:
        config = exp_config(out)
        path = export_program(config, os.path.join(out, "avg_model.pt"),
                              os.path.join(out, "model.pt2"))
        print(f"torch.export program -> {path}")
    print(f"exported model dir -> {out}")


if __name__ == "__main__":
    main()
