"""Checkpoints of the port: `.pt` state_dicts in the port's names with a
JSON sidecar of step / epoch metadata.

Counterpart of `wespeaker_hubert_tpu/utils/checkpoint.py` for the port's own
files: `save_checkpoint` writes atomically, `load_partial` loads whatever
names and shapes match into a SpeakerNet and reports the rest (strict=False
semantics, so a frontend-only or backbone-only checkpoint initializes what it
holds), and `latest_checkpoint` finds the newest `model_N.pt`.  A
`model_N.pt` holds the SpeakerNet's state_dict (backbone unprefixed,
`frontend.`, `projection.`), which `bin/extract` and `bin/serve` load as it
is.  Reading the JAX package's flax-msgpack `.ckpt` files is not ported yet.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "load_partial", "latest_checkpoint",
           "average_checkpoints"]


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


def load_partial(path: str, net) -> Tuple[List[str], List[str]]:
    """Load the state_dict at `path` into a SpeakerNet where names and
    shapes match; returns (missing, unexpected) names, a name whose shape
    differs counting as unexpected (its parameter keeps its value)."""
    from ..models.speaker_net import load_speaker_state, speaker_state_dict

    state = load_checkpoint(path)
    own = speaker_state_dict(net)
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
