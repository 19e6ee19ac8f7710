"""SimAM-attention ResNet (the VoxBlink2 models) in PyTorch.

Counterpart of `wespeaker_hubert_tpu/models/samresnet.py`, in WeSpeaker's
names and NCHW (B, C, F, T) layout (reference wespeaker/models/
samresnet.py): `front.conv1` / `front.bn1`, `front.layer{L}.{i}` blocks
(`conv1`, `bn1`, `conv2`, `bn2`, the projection shortcut
`downsample.0` / `.1`), the pooling `pooling` (ASP, its `attention`
Sequential) and `bottleneck`.  SimAM is the parameter-free energy attention
x * sigmoid(d / (4 (v + 1e-4)) + 1/2) over each channel's (F, T) plane.
The frame map flattens channel-major before ASP, as WeSpeaker's does; the
JAX module flattens frequency-major (the port's converter permutes the
attention convs and `bottleneck`).  The pooling mask follows the three
stride-2 stages.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm import BatchNorm2d
from .pooling import ASP
from .resnet import downsample_mask, strided_size

__all__ = ["simam", "SimAMBasicBlock", "SimAMResNet", "SimAM_ResNet34_ASP",
           "SimAM_ResNet100_ASP"]


def _bn2d(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def simam(x: torch.Tensor, lambda_p: float = 1e-4) -> torch.Tensor:
    """SimAM over (B, C, F, T): the energy attention per channel."""
    n = x.shape[2] * x.shape[3] - 1
    d = (x - x.mean(dim=(2, 3), keepdim=True)) ** 2
    v = d.sum(dim=(2, 3), keepdim=True) / n
    return x * torch.sigmoid(d / (4 * (v + lambda_p)) + 0.5)


class SimAMBasicBlock(nn.Module):
    """3x3 -> BN -> ReLU -> 3x3 -> BN -> SimAM, plus the shortcut, ReLU."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = _bn2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn2d(planes)
        self.downsample = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False), _bn2d(planes))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = simam(self.bn2(self.conv2(out)))
        return F.relu(out + self.downsample(x))


class _Front(nn.Module):
    """The ResNet front: stem and four stages of SimAM blocks."""

    def __init__(self, in_planes: int, num_blocks: Sequence[int]):
        super().__init__()
        self.conv1 = nn.Conv2d(1, in_planes, 3, padding=1, bias=False)
        self.bn1 = _bn2d(in_planes)
        planes = in_planes
        for li, (mult, stride) in enumerate(zip((1, 2, 4, 8), (1, 2, 2, 2))):
            blocks = []
            for bi in range(num_blocks[li]):
                blocks.append(SimAMBasicBlock(planes, in_planes * mult, stride if bi == 0 else 1))
                planes = in_planes * mult
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        return self.layer4(self.layer3(self.layer2(self.layer1(out))))


class SimAMResNet(nn.Module):
    """SimAM ResNet front + ASP + `bottleneck`: (B, T, feat_dim) features ->
    (B, embed_dim)."""

    def __init__(self, in_planes: int, num_blocks: Sequence[int], embed_dim: int = 256,
                 feat_dim: int = 80):
        super().__init__()
        self.feat_dim = feat_dim
        self.embed_dim = embed_dim
        self.front = _Front(in_planes, num_blocks)
        stats_dim = in_planes * 8 * strided_size(feat_dim, 3)
        self.pooling = ASP(stats_dim)
        self.bottleneck = nn.Linear(2 * stats_dim, embed_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        out = self.front(x.transpose(1, 2).unsqueeze(1))
        b, c, f, t = out.shape
        if mask is not None:
            mask = downsample_mask(mask, t)
        return self.bottleneck(self.pooling(out.reshape(b, c * f, t), mask))


def SimAM_ResNet34_ASP(feat_dim=80, embed_dim=256, **kw):
    return SimAMResNet(64, (3, 4, 6, 3), embed_dim, feat_dim)


def SimAM_ResNet100_ASP(feat_dim=80, embed_dim=256, **kw):
    return SimAMResNet(64, (6, 16, 24, 3), embed_dim, feat_dim)
