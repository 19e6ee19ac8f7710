"""Checkpoints of the port: `.pt` state_dicts in the port's names with a
JSON sidecar of step / epoch metadata.

Counterpart of `wespeaker_hubert_tpu/utils/checkpoint.py` for the port's own
files: `save_checkpoint` writes atomically, `load_partial` loads whatever
names and shapes match into a SpeakerNet and reports the rest (strict=False
semantics, so a frontend-only or backbone-only checkpoint initializes what it
holds), and `latest_checkpoint` finds the newest `model_N.pt`.  A
`model_N.pt` holds the SpeakerNet's state_dict (backbone unprefixed,
`frontend.`, `projection.`), which `bin/extract` and `bin/serve` load as it
is.

The JAX package's own files, flax msgpack (`model_N.ckpt`, `avg_model.ckpt`:
`{"params": {"backbone", "projection", ["frontend"]}, "batch_stats": ...}`),
are read by `load_jax_checkpoint` (utils/flax_msgpack.py, no msgpack package)
and reach the port's names through `models/convert_jax.py`; `load_state` and
`load_partial` take either format, and both layouts of the JAX package's
DINO teacher checkpoints (statistics nested under `backbone` or flat).
`load_partial` refuses a checkpoint that holds a BatchNorm layer's
parameters without its running statistics.  JAX's `train_state.ckpt` (with the
optimizer state) is not read.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "load_jax_checkpoint", "load_state",
           "load_partial", "latest_checkpoint", "average_checkpoints"]


def save_checkpoint(path: str, obj: Any, meta: Optional[Dict] = None) -> None:
    """torch.save `obj` to `path` (and `meta` to `path + '.json'`) through
    temporary files and renames."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    if meta is not None:
        mtmp = f"{path}.json.tmp{os.getpid()}"
        with open(mtmp, "w") as f:
            json.dump(meta, f)
        os.replace(mtmp, path + ".json")


def load_checkpoint(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_jax_checkpoint(path: str) -> Dict:
    """The tree of a JAX package checkpoint (flax msgpack): nested dicts of
    numpy arrays, bfloat16 leaves as torch.bfloat16 tensors."""
    from .flax_msgpack import load

    return load(path)


def load_state(path: str, model: Optional[str] = None,
               feat_dim: int = 80) -> Dict[str, torch.Tensor]:
    """The checkpoint at `path` as a state_dict in the port's names: a
    `torch.save` file (a zip archive, or a legacy pickle) as it is, or a JAX
    `.ckpt` converted by `from_jax_variables(model, ..., feat_dim)`, which
    needs the model's name (and, for ResNet, its input width)."""
    with open(path, "rb") as f:
        head = f.read(2)
    # zip's local-file header, or pickle's protocol opcode: a JAX checkpoint
    # is a msgpack map, whose first byte is 0x80-0x8f, 0xde or 0xdf
    if head == b"PK" or (head[:1] == b"\x80" and head[1:2] in (b"\x02", b"\x03", b"\x04",
                                                              b"\x05")):
        return load_checkpoint(path)
    from ..models.convert_jax import from_jax_variables

    tree = load_jax_checkpoint(path)
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: neither a port .pt nor a JAX model checkpoint")
    if "opt_state" in tree:
        raise NotImplementedError(
            f"{path}: a JAX train_state.ckpt (optimizer state) is not read by the port; "
            "load the epoch's model_N.ckpt")
    if model is None:
        raise ValueError(f"{path} is a JAX checkpoint: its conversion needs the model name")
    return from_jax_variables(model, _nest_backbone_stats(path, tree), feat_dim=feat_dim)


def _nest_backbone_stats(path: str, tree: Dict) -> Dict:
    """A JAX SSL checkpoint's statistics under `batch_stats/backbone`.
    bin/train_dino.py nests the teacher's statistics there, beside
    `params/backbone`; examples/voxceleb/v3/dino/run.py writes them flat
    (the backbone's modules at the top of `batch_stats`): those move under
    `backbone`.  Flat statistics that are not the backbone's are refused,
    never dropped."""
    params, stats = tree["params"], tree.get("batch_stats") or {}
    if "backbone" not in params or not stats or "backbone" in stats:
        return tree
    if set(stats) <= set(params["backbone"]):
        return {**tree, "batch_stats": {"backbone": stats}}
    raise ValueError(
        f"{path}: batch_stats beside params/backbone name modules the backbone does not have "
        f"({sorted(set(stats) - set(params['backbone']))[:4]}): neither the nested nor the flat "
        "layout of a JAX SSL checkpoint")


def load_partial(path: str, net, model: Optional[str] = None) -> Tuple[List[str], List[str]]:
    """Load the checkpoint at `path` (a port `.pt`, or a JAX `.ckpt` of the
    model named `model`) into a SpeakerNet where names and shapes match;
    returns (missing, unexpected) names, a name whose shape differs counting
    as unexpected (its parameter keeps its value)."""
    from ..models.speaker_net import load_speaker_state, speaker_state_dict

    state = load_state(path, model, getattr(net.backbone, "feat_dim", 80))
    own = speaker_state_dict(net)
    fresh = [k for k in own if k.endswith(("running_mean", "running_var")) and k not in state
             and not k.startswith(("frontend.", "projection."))
             and k.rsplit(".", 1)[0] + ".weight" in state]
    if fresh:
        raise ValueError(f"{path} holds the parameters of {len(fresh)} BatchNorm layers without "
                         f"their statistics ({fresh[:2]}...): refusing to load them with fresh "
                         "running statistics")
    mismatched = [k for k, v in state.items() if k in own and own[k].shape != v.shape]
    state = {k: v for k, v in state.items() if k not in mismatched}
    missing, unexpected = load_speaker_state(net, state)
    missing = [k for k in missing if k not in mismatched]
    return missing, unexpected + mismatched


def latest_checkpoint(directory: str, pattern: str = r"model_(\d+)\.pt") -> Optional[str]:
    """The epoch checkpoint with the highest N in `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    best, best_epoch = None, -1
    rx = re.compile(pattern)
    for name in os.listdir(directory):
        m = rx.fullmatch(name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(directory, name)
    return best


def average_checkpoints(paths: List[str]) -> Dict[str, torch.Tensor]:
    """Uniform average of the state_dicts at `paths` (JAX
    `utils/checkpoint.py:average_checkpoints`): floating tensors are summed
    in file order in float32 and divided by their count, as numpy's mean
    over the stacked arrays does; integer tensors (BatchNorm's
    `num_batches_tracked`) are taken from the last file.  The names are the
    files' own, so the result loads wherever they do."""
    if not paths:
        raise ValueError("no checkpoints to average")
    states = [load_checkpoint(p) for p in paths]
    names = list(states[0])
    for p, st in zip(paths[1:], states[1:]):
        if list(st) != names:
            raise ValueError(f"{p}: its tensor names differ from {paths[0]}'s")
    out = {}
    for k in names:
        if states[0][k].is_floating_point():
            acc = states[0][k].float().clone()
            for st in states[1:]:
                acc += st[k].float()
            out[k] = (acc / len(states)).to(states[0][k].dtype)
        else:
            out[k] = states[-1][k].clone()
    return out
