"""Learning-rate and margin schedules as plain functions of the step.

Counterpart of `wespeaker_hubert_tpu/train/schedulers.py`: each schedule is
`f(step) -> float`, evaluated in float32 as the JAX package evaluates it,
and the trainer sets the value before each step.

  * margin: the initial margin before increase_start, an exp (or linear)
    ramp to the final margin until fix_start, the final margin after;
  * ExponentialDecrease: lr = coeff * initial * exp(t / T * ln(final /
    initial)), with the warm-up coefficient ramping to scale_ratio over
    warm_up_epoch epochs;
  * TriAngular2: a cyclic triangular schedule with halving peaks.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["MarginSchedule", "ExponentialDecrease", "TriAngular2", "get_lr_schedule"]

_F = np.float32


@dataclasses.dataclass(frozen=True)
class MarginSchedule:
    epoch_iter: int
    increase_start_epoch: int
    fix_start_epoch: int
    initial_margin: float
    final_margin: float
    increase_type: str = "exp"  # 'exp' or 'linear'
    update_margin: bool = True

    def __call__(self, step) -> float:
        """The margin at iteration `step` (0-based)."""
        if not self.update_margin:
            return float(_F(self.initial_margin))
        inc_start = (self.increase_start_epoch - 1) * self.epoch_iter
        fix_start = (self.fix_start_epoch - 1) * self.epoch_iter
        inc_iters = max(fix_start - inc_start, 1)
        if step < inc_start:
            return float(_F(self.initial_margin))
        if step >= fix_start:
            return float(_F(self.final_margin))
        t = (_F(step) - _F(inc_start)) / _F(inc_iters)
        if self.increase_type == "exp":
            ratio = _F(1.0) - np.exp(t * _F(math.log(1e-3 / (1.0 + 1e-6))))
        else:
            ratio = t
        return float(_F(self.initial_margin) + _F(self.final_margin - self.initial_margin) * ratio)


@dataclasses.dataclass(frozen=True)
class _LrBase:
    num_epochs: int
    epoch_iter: int
    initial_lr: float
    final_lr: float
    warm_up_epoch: int = 6
    scale_ratio: float = 1.0
    warm_from_zero: bool = False

    def _coeff(self, step) -> np.float32:
        warm_iter = self.warm_up_epoch * self.epoch_iter
        t = _F(step)
        full = _F(self.scale_ratio)
        if t >= warm_iter:
            return full
        if self.warm_from_zero:
            return full * t / _F(warm_iter)
        if self.scale_ratio > 1:
            return _F(self.scale_ratio - 1.0) * t / _F(warm_iter) + _F(1.0)
        return full


@dataclasses.dataclass(frozen=True)
class ExponentialDecrease(_LrBase):
    def __call__(self, step) -> float:
        max_iter = self.num_epochs * self.epoch_iter
        t = _F(step)
        decay = np.exp((t / _F(max_iter)) * _F(math.log(self.final_lr / self.initial_lr)))
        return float(self._coeff(step) * _F(self.initial_lr) * decay)


@dataclasses.dataclass(frozen=True)
class TriAngular2(_LrBase):
    cycle_step: int = 2
    reduce_lr_diff_ratio: float = 0.5

    def __call__(self, step) -> float:
        cycle_iter = self.cycle_step * self.epoch_iter
        step_size = cycle_iter // 2
        min_lr = _F(self.final_lr)
        gap = _F(self.initial_lr - self.final_lr)
        point = _F(int(step) % cycle_iter)
        cycle_index = _F(int(step) // cycle_iter)
        max_lr = min_lr + gap * _F(self.reduce_lr_diff_ratio) ** cycle_index
        if point <= step_size:
            lr = min_lr + (max_lr - min_lr) * point / _F(step_size)
        else:
            lr = max_lr - (max_lr - min_lr) * (point - _F(step_size)) / _F(step_size)
        return float(self._coeff(step) * lr)


def get_lr_schedule(name: str, **kwargs):
    table = {"ExponentialDecrease": ExponentialDecrease, "TriAngular2": TriAngular2}
    try:
        return table[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown LR scheduler {name!r}") from None
