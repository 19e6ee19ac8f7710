"""r-vector ResNet speaker-embedding backbones in PyTorch.

Counterpart of `wespeaker_hubert_tpu/models/resnet.py` (its direct path;
the space-to-depth stem, `resnet_s2d.py`, is a TPU lane-packing rewrite of
the same function and has no counterpart here).  The public forward takes
(B, T, feat_dim) features and an optional (B, T) bool mask, as the JAX
module does; inside, the frame map is NCHW (B, C, F, T), WeSpeaker's layout
(reference wespeaker/models/resnet.py), and so are the parameter names:
`conv1`, `bn1`, `layer{L}.{i}.conv{k}` / `.bn{k}`,
`layer{L}.{i}.shortcut.0` / `.1`, `pool`, `seg_1` and, with
`two_emb_layer`, `seg_bn_1` (no affine) and `seg_2`.  A published WeSpeaker
state_dict loads as it is.

The frame map (B, C', F', T') flattens channel-major to (B, C' * F', T')
before pooling, as WeSpeaker's does; the JAX package flattens
frequency-major, so its `seg_1` rows reach the port permuted
(models/convert_jax.py).  For the multi-head poolings (MHASTP, MQMHASTP),
whose heads split that axis, the port flattens frequency-major as the JAX
package does (`flatten_frame_map`), and `seg_1` comes across unpermuted.
Each stride-2 stage halves time and frequency with ceil division, and the
pooling mask follows as the JAX one does:
`mask[:, ::2]` three times, then `[:, :T']`.

forward returns `(embed_a, embed_b)` with `two_emb_layer`, else
`(0-d zero, embed_a)`, so `registry.embedding_from_outputs` takes the last.
"""

from __future__ import annotations

from typing import Optional, Sequence, Type

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm import BatchNorm1d, BatchNorm2d
from .pooling import MULTI_HEAD_POOLINGS, POOLING_LAYERS, pooling_output_dim

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "FrameMapNet",
    "downsample_mask",
    "flatten_frame_map",
    "strided_size",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "ResNet152",
    "ResNet221",
    "ResNet293",
]


def _bn2d(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def _shortcut(in_planes: int, out_planes: int, stride: int) -> nn.Sequential:
    """Identity (an empty Sequential, WeSpeaker's) or a strided 1x1 conv + BN."""
    if stride == 1 and in_planes == out_planes:
        return nn.Sequential()
    return nn.Sequential(
        nn.Conv2d(in_planes, out_planes, 1, stride=stride, bias=False), _bn2d(out_planes))


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (reference resnet.py BasicBlock)."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = _bn2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn2d(planes)
        self.shortcut = _shortcut(in_planes, planes, stride)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self.shortcut(x))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 bottleneck (reference resnet.py Bottleneck)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = _bn2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = _bn2d(planes)
        self.conv3 = nn.Conv2d(planes, out_planes, 1, bias=False)
        self.bn3 = _bn2d(out_planes)
        self.shortcut = _shortcut(in_planes, out_planes, stride)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + self.shortcut(x))


def downsample_mask(mask: torch.Tensor, t: int, strides: int = 3) -> torch.Tensor:
    """The (B, T) validity mask after `strides` stride-2 (pad 1, kernel 3)
    stages of a T' = `t` frame map, as the JAX module cuts it."""
    for _ in range(strides):
        mask = mask[:, ::2]
    return mask[:, :t]


def strided_size(n: int, strides: int) -> int:
    """A length after `strides` stride-2 (pad 1, kernel 3) convolutions."""
    for _ in range(strides):
        n = (n + 1) // 2
    return n


def flatten_frame_map(out: torch.Tensor, pooling_func: str) -> torch.Tensor:
    """(B, C, F, T) -> (B, C * F, T), channel-major (row c * F + f), or
    frequency-major (row f * C + c, the JAX package's order) for the
    multi-head poolings, whose heads split the rows."""
    b, c, f, t = out.shape
    if pooling_func in MULTI_HEAD_POOLINGS:
        out = out.transpose(1, 2)
    return out.reshape(b, c * f, t)


class FrameMapNet(nn.Module):
    """The embedding head of the 2-D backbones (ResNet, so Res2Net, and
    ERes2Net; Gemini DF-ResNet): the last frame map (B, C', F', T')
    flattened channel-major, pooled under the mask downsampled by the
    backbone's `time_strides` stride-2 stages, `seg_1` and, with
    `two_emb_layer`, ReLU -> `seg_bn_1` (no affine) -> `seg_2`."""

    def _init_head(self, feat_dim: int, channels: int, embed_dim: int, pooling_func: str,
                   two_emb_layer: bool, freq: Optional[int] = None,
                   time_strides: int = 3) -> None:
        self.feat_dim = feat_dim
        self.embed_dim = embed_dim
        self.two_emb_layer = two_emb_layer
        self.time_strides = time_strides
        self.pooling_func = pooling_func
        # WeSpeaker's stats_dim: feat_dim / 8 frequency rows of the last map
        # (`freq` where the backbone strides frequency otherwise)
        stats_dim = (int(feat_dim / 8) if freq is None else freq) * channels
        self.pool = POOLING_LAYERS[pooling_func](in_dim=stats_dim)
        self.seg_1 = nn.Linear(pooling_output_dim(pooling_func, stats_dim), embed_dim)
        if two_emb_layer:
            self.seg_bn_1 = BatchNorm1d(embed_dim, eps=1e-5, momentum=0.1, affine=False)
            self.seg_2 = nn.Linear(embed_dim, embed_dim)

    def _head(self, out: torch.Tensor, mask: Optional[torch.Tensor]):
        if mask is not None:
            mask = downsample_mask(mask, out.shape[-1], self.time_strides)
        embed_a = self.seg_1(self.pool(flatten_frame_map(out, self.pooling_func), mask))
        if self.two_emb_layer:
            return embed_a, self.seg_2(self.seg_bn_1(F.relu(embed_a)))
        return embed_a.new_zeros(()), embed_a


class ResNet(FrameMapNet):
    """Speaker ResNet over (B, T, F) features (reference resnet.py ResNet)."""

    def __init__(
        self,
        block: Type[nn.Module],
        num_blocks: Sequence[int],
        m_channels: int = 32,
        feat_dim: int = 40,
        embed_dim: int = 128,
        pooling_func: str = "TSTP",
        two_emb_layer: bool = False,
    ):
        super().__init__()
        self.conv1 = nn.Conv2d(1, m_channels, 3, padding=1, bias=False)
        self.bn1 = _bn2d(m_channels)
        in_planes = m_channels
        for li, (mult, stride) in enumerate(zip((1, 2, 4, 8), (1, 2, 2, 2))):
            blocks = []
            for bi in range(num_blocks[li]):
                blocks.append(block(in_planes, m_channels * mult, stride if bi == 0 else 1))
                in_planes = m_channels * mult * block.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self._init_head(feat_dim, in_planes, embed_dim, pooling_func, two_emb_layer)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        out = x.transpose(1, 2).unsqueeze(1)  # (B, T, F) -> (B, 1, F, T)
        out = F.relu(self.bn1(self.conv1(out)))
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        return self._head(out, mask)


def ResNet18(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return ResNet(BasicBlock, (2, 2, 2, 2), 32, feat_dim, embed_dim, pooling_func, two_emb_layer)


def ResNet34(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return ResNet(BasicBlock, (3, 4, 6, 3), 32, feat_dim, embed_dim, pooling_func, two_emb_layer)


def ResNet50(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return ResNet(Bottleneck, (3, 4, 6, 3), 32, feat_dim, embed_dim, pooling_func, two_emb_layer)


def ResNet101(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return ResNet(Bottleneck, (3, 4, 23, 3), 32, feat_dim, embed_dim, pooling_func,
                  two_emb_layer)


def ResNet152(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return ResNet(Bottleneck, (3, 8, 36, 3), 32, feat_dim, embed_dim, pooling_func,
                  two_emb_layer)


def ResNet221(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return ResNet(Bottleneck, (6, 16, 48, 3), 32, feat_dim, embed_dim, pooling_func,
                  two_emb_layer)


def ResNet293(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return ResNet(Bottleneck, (10, 20, 64, 3), 32, feat_dim, embed_dim, pooling_func,
                  two_emb_layer)
