"""Res2Net r-vector backbones (multi-scale residual blocks) in PyTorch.

Counterpart of `wespeaker_hubert_tpu/models/res2net.py`, in models/resnet.py's
conventions: (B, T, feat_dim) features and an optional (B, T) mask in, an
NCHW (B, C, F, T) frame map inside, WeSpeaker's parameter names (reference
wespeaker/models/res2net.py): `conv1`, `bn1`,
`layer{L}.{i}.{conv1, bn1, convs.{k}, bns.{k}, conv3, bn3, shortcut.0,
shortcut.1}`, `pool`, `seg_1` and, with `two_emb_layer`, `seg_bn_1` and
`seg_2`: a Res2Net is models/resnet.py's ResNet over BasicBlockRes2Net.

Block: 1x1 (strided) -> `scale` splits of `width` channels, the first
`scale - 1` through 3x3 convs each fed the previous conv's output plus its
own split, the last passed through -> 1x1 expand (x2), shortcut, ReLU.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import ResNet, _bn2d, _shortcut

__all__ = ["BasicBlockRes2Net", "Res2Net", "Res2Net34_Base", "Res2Net34_Large"]


class BasicBlockRes2Net(nn.Module):
    expansion = 2

    def __init__(self, in_planes: int, planes: int, stride: int = 1, base_width: int = 32,
                 scale: int = 2):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0)))
        out_planes = planes * self.expansion
        self.width = width
        self.conv1 = nn.Conv2d(in_planes, width * scale, 1, stride=stride, bias=False)
        self.bn1 = _bn2d(width * scale)
        self.convs = nn.ModuleList(
            nn.Conv2d(width, width, 3, padding=1, bias=False) for _ in range(scale - 1))
        self.bns = nn.ModuleList(_bn2d(width) for _ in range(scale - 1))
        self.conv3 = nn.Conv2d(width * scale, out_planes, 1, bias=False)
        self.bn3 = _bn2d(out_planes)
        self.shortcut = _shortcut(in_planes, out_planes, stride)

    def forward(self, x):
        spx = torch.split(F.relu(self.bn1(self.conv1(x))), self.width, 1)
        outs = []
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = spx[0] if i == 0 else sp + spx[i]
            sp = F.relu(bn(conv(sp)))
            outs.append(sp)
        out = self.bn3(self.conv3(torch.cat(outs + [spx[-1]], dim=1)))
        return F.relu(out + self.shortcut(x))


def Res2Net(m_channels: int, num_blocks: Sequence[int], feat_dim: int = 80,
            embed_dim: int = 192, pooling_func: str = "TSTP",
            two_emb_layer: bool = False) -> ResNet:
    """The JAX module's signature: a ResNet of BasicBlockRes2Net (its stem,
    stages and head are ResNet's)."""
    return ResNet(BasicBlockRes2Net, num_blocks, m_channels, feat_dim, embed_dim, pooling_func,
                  two_emb_layer)


def Res2Net34_Base(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return Res2Net(32, (3, 4, 6, 3), feat_dim, embed_dim, pooling_func, two_emb_layer)


def Res2Net34_Large(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return Res2Net(64, (3, 4, 6, 3), feat_dim, embed_dim, pooling_func, two_emb_layer)
