"""Dtype-preserving normalization layers.

Counterpart of `wespeaker_hubert_tpu/models/norm.py`: statistics and the
affine transform in float32, the result in the input's dtype, so a bf16
forward stays bf16 and keeps float32 statistics.  Parameter names are
torch's (`weight`, `bias`), as HuggingFace's encoders use them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["LayerNorm", "GroupNorm"]


def _f32(p):
    return None if p is None else p.float()


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm over the last dim with float32 statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, _f32(self.weight), _f32(self.bias), self.eps
        ).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm over (B, C, ...) with float32 statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(
            x.float(), self.num_groups, _f32(self.weight), _f32(self.bias), self.eps
        ).to(x.dtype)
