"""Golden-Gemini DF-ResNet in PyTorch: depth-first inverted bottlenecks with
one temporal stride.

Counterpart of `wespeaker_hubert_tpu/models/gemini_dfresnet.py`, in
WeSpeaker's names and NCHW (B, C, F, T) layout (reference
wespeaker/models/gemini_dfresnet.py): `downsample_layers.0` is the stem
(3x3 conv, BatchNorm; ReLU), `downsample_layers.{1..4}` the strided 3x3
conv + BatchNorm before each stage, `stages.{i}.{j}` the inverted
bottlenecks (`conv1` 1x1 expand x4, `conv2` 3x3 depthwise — a plain
`groups=channels` Conv2d —, `conv3` 1x1 project, each with its `bn`).
Frequency strides by 2 at every stage (F / 16 in all), time only at stage 2
(the T14c strategy), and the pooling mask follows that one stride.  The
head is resnet.py's FrameMapNet: the last map flattened channel-major, as
WeSpeaker does, where the JAX module flattens frequency-major (the port's
converter permutes `seg_1`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import FrameMapNet, strided_size
from .norm import BatchNorm2d

__all__ = [
    "InvertedBottleneck",
    "Gemini_DF_ResNet",
    "Gemini_DF_ResNet60",
    "Gemini_DF_ResNet114",
    "Gemini_DF_ResNet183",
    "Gemini_DF_ResNet237",
]

STRIDE_F = (2, 2, 2, 2)
STRIDE_T = (1, 2, 1, 1)


def _bn2d(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class InvertedBottleneck(nn.Module):
    """1x1 expand x4 -> 3x3 depthwise -> 1x1 project, residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, 4 * dim, 1, bias=False)
        self.bn1 = _bn2d(4 * dim)
        self.conv2 = nn.Conv2d(4 * dim, 4 * dim, 3, padding=1, groups=4 * dim, bias=False)
        self.bn2 = _bn2d(4 * dim)
        self.conv3 = nn.Conv2d(4 * dim, dim, 1, bias=False)
        self.bn3 = _bn2d(dim)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + x)


class Gemini_DF_ResNet(FrameMapNet):
    """(B, T, feat_dim) features -> (embed_a, embed_b) with `two_emb_layer`,
    else (0-d zero, embed_a)."""

    def __init__(self, depths: Sequence[int], dims: Sequence[int], feat_dim: int = 40,
                 embed_dim: int = 128, pooling_func: str = "TSTP",
                 two_emb_layer: bool = False):
        super().__init__()
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            nn.Conv2d(1, dims[0], 3, padding=1, bias=False), _bn2d(dims[0]), nn.ReLU())])
        for i in range(4):
            self.downsample_layers.append(nn.Sequential(
                nn.Conv2d(dims[i], dims[i + 1], 3, stride=(STRIDE_F[i], STRIDE_T[i]), padding=1,
                          bias=False),
                _bn2d(dims[i + 1])))
        self.stages = nn.ModuleList([
            nn.Sequential(*[InvertedBottleneck(dims[i + 1]) for _ in range(depths[i])])
            for i in range(4)])
        self._init_head(feat_dim, dims[-1], embed_dim, pooling_func, two_emb_layer,
                        freq=strided_size(feat_dim, 4), time_strides=1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        out = self.downsample_layers[0](x.transpose(1, 2).unsqueeze(1))  # (B, 1, F, T)
        for down, stage in zip(self.downsample_layers[1:], self.stages):
            out = stage(down(out))
        return self._head(out, mask)


def Gemini_DF_ResNet60(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return Gemini_DF_ResNet((3, 3, 9, 3), (32, 32, 64, 128, 256), feat_dim, embed_dim,
                            pooling_func, two_emb_layer)


def Gemini_DF_ResNet114(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return Gemini_DF_ResNet((3, 3, 27, 3), (32, 32, 64, 128, 256), feat_dim, embed_dim,
                            pooling_func, two_emb_layer)


def Gemini_DF_ResNet183(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return Gemini_DF_ResNet((3, 8, 45, 3), (32, 32, 64, 128, 256), feat_dim, embed_dim,
                            pooling_func, two_emb_layer)


def Gemini_DF_ResNet237(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return Gemini_DF_ResNet((3, 8, 63, 3), (32, 32, 64, 128, 256), feat_dim, embed_dim,
                            pooling_func, two_emb_layer)
