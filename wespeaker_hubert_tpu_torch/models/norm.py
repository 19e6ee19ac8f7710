"""Dtype-preserving normalization layers.

Counterpart of `wespeaker_hubert_tpu/models/norm.py`: statistics and the
affine transform in float32, the result in the input's dtype, so a bf16
forward stays bf16 and keeps float32 statistics.  Parameter names are
torch's (`weight`, `bias`, `running_mean`, `running_var`), as WeSpeaker's
and HuggingFace's modules use them.

A float64 input keeps float64 throughout (`upcast`), so the modules also
compute a float64 reference.

`BatchNorm1d` and `BatchNorm2d` in train mode follow flax's `BatchNorm`:
batch statistics in float32 over every axis but the channels (the variance
as E[x^2] - E[x]^2, clipped at 0), the running mean and variance updated as
`momentum * running + (1 - momentum) * batch` with flax's momentum 0.9
(torch's momentum 0.1, the weight of the new batch) and the *biased* batch
variance, where torch's own BatchNorm stores the unbiased one.  In eval
they are torch's BatchNorm1d / BatchNorm2d.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["BatchNorm1d", "BatchNorm2d", "LayerNorm", "GroupNorm", "upcast"]


def upcast(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or as it is when it is float64: statistics are taken
    in at least float32."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _f32(p):
    return None if p is None else upcast(p)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm over the last dim with float32 statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            upcast(x), self.normalized_shape, _f32(self.weight), _f32(self.bias), self.eps
        ).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm over (B, C, ...) with float32 statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(
            upcast(x), self.num_groups, _f32(self.weight), _f32(self.bias), self.eps
        ).to(x.dtype)


def _flax_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Train-mode BatchNorm over (B, C, ...) as flax computes it (see the
    module doc); updates `bn`'s running statistics."""
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    x32 = upcast(x)
    mean = x32.mean(dims)
    # flax's fast variance E[x^2] - E[x]^2, clipped at 0
    var = torch.clamp_min((x32 * x32).mean(dims) - mean * mean, 0.0)
    mul = torch.rsqrt(var + bn.eps)
    if bn.weight is not None:
        mul = mul * upcast(bn.weight)
    y = (x32 - mean.view(shape)) * mul.view(shape)
    if bn.bias is not None:
        y = y + upcast(bn.bias).view(shape)
    if bn.track_running_stats:
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean)
            bn.running_var.copy_((1.0 - m) * bn.running_var + m * var)
            bn.num_batches_tracked.add_(1)
    return y.to(x.dtype)


class BatchNorm1d(nn.BatchNorm1d):
    """nn.BatchNorm1d over (B, C) or (B, C, T) whose train mode gives flax's
    output and running statistics (float32 statistics, biased running
    variance); the running statistics stay float32 under a bf16 forward."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return _flax_batch_norm(self, x)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d over (B, C, H, W) with BatchNorm1d's train mode (its
    own class: nn.BatchNorm1d refuses 4-D input)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return _flax_batch_norm(self, x)
