"""Train state and optimizer construction.

Counterpart of `wespeaker_hubert_tpu/train/state.py`.  The optimizer is
torch's SGD with coupled weight decay and (nesterov) momentum, which is the
JAX package's `chain(add_decayed_weights, trace(momentum, nesterov),
scale_by_schedule(-lr))` and its fused `_make_sgd_update_apply`:

    u     = g + wd * p
    m_new = u + momentum * m
    p_new = p - lr(step) * (u + momentum * m_new)     [nesterov]
    p_new = p - lr(step) * m_new                      [otherwise]

with the learning rate of the schedule at the step set before each update.
Adam and AdamW follow the JAX package's chains with optax's defaults (b1
0.9, b2 0.999, eps 1e-8 outside the square root, bias correction from step
1).  Adam puts the coupled decay before `scale_by_adam`, which is
`torch.optim.Adam(weight_decay=...)`; AdamW decays decoupled after it, both
scaled by -lr, which is `torch.optim.AdamW`:

    p_new = p - lr(step) * (adam(g) + wd * p)

The decay reaches every trainable tensor (BatchNorm and the head too), as in
JAX: there are no parameter groups.

`freeze_paths` turns `requires_grad` off, so a frozen parameter gets neither
an update nor weight decay (the JAX package's `set_to_zero` partition).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

__all__ = ["TrainState", "freeze_paths", "make_optimizer"]


def freeze_paths(model: torch.nn.Module, paths: Sequence[Tuple[str, ...]]) -> List[str]:
    """`requires_grad_(False)` on every parameter whose dotted name holds
    all the keys of one of `paths` (e.g. ("frontend", "upstream")); returns
    the frozen names."""
    frozen = []
    for name, p in model.named_parameters():
        keys = name.split(".")
        if any(all(k in keys for k in path) for path in paths):
            p.requires_grad_(False)
            frozen.append(name)
    return frozen


def make_optimizer(
    model: torch.nn.Module,
    optimizer: str = "SGD",
    momentum: float = 0.9,
    nesterov: bool = True,
    weight_decay: float = 1e-4,
) -> torch.optim.Optimizer:
    """SGD, Adam or AdamW over the model's trainable parameters, as the JAX
    package's chains (module doc); the learning rate is set per step by
    `TrainState.apply_gradients`."""
    params = [p for p in model.parameters() if p.requires_grad]
    kind = optimizer.upper()
    if kind == "SGD":
        return torch.optim.SGD(
            params, lr=0.0, momentum=momentum, nesterov=bool(nesterov and momentum),
            weight_decay=weight_decay,
        )
    if kind in ("ADAM", "ADAMW"):
        cls = torch.optim.Adam if kind == "ADAM" else torch.optim.AdamW
        return cls(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {optimizer!r}")


class TrainState:
    """The model, its optimizer, the LR schedule and the step counter (the
    number of optimizer steps taken, which the schedules read)."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 lr_schedule: Callable[[int], float], step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.step = step

    def apply_gradients(self) -> float:
        """One optimizer step at lr(step) with the gradients in .grad; returns
        the learning rate used."""
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return lr

    def state_dict(self) -> Dict:
        return {"step": self.step, "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.step = int(state["step"])
        self.optimizer.load_state_dict(state["optimizer"])
