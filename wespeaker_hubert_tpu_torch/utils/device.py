"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The torch.device an entry point runs on.  A CUDA device that does
    not exist raises; only an explicit CPU device runs on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
