"""ERes2Net: Res2Net with attentional feature fusion (AFF) inside its
blocks and bottom-up across its stages, in PyTorch.

Counterpart of `wespeaker_hubert_tpu/models/eres2net.py`, in
models/resnet.py's conventions ((B, T, feat_dim) features and an optional
(B, T) mask in, an NCHW (B, C, F, T) frame map inside, ResNet's head and
mask downsampling through `FrameMapNet`) and with the parameter names the
JAX package's converter reads (`models/convert_torch.py:eres2net_from_torch`):
`conv1`, `bn1`; `layer{1,2}.{i}.{conv1, bn1, convs.{k}, bns.{k}, conv3,
bn3, shortcut.0, shortcut.1}` (all `scale` splits convolved);
`layer{3,4}.{i}.{conv1, bn1, conv2_1, bn2_1, convs.{k}, bns.{k},
fuse_models.{k}.local_att.{0,1,3,4}, conv3, bn3, shortcut.*}` (the
splits after the first fused to the running output by AFF);
`layer{1,2,3}_downsample`; `fuse_mode12`, `fuse_mode123`, `fuse_mode1234`
(AFFs, `local_att.{0,1,3,4}`: 1x1 conv with bias, BatchNorm, SiLU, 1x1
conv with bias, BatchNorm); `pool`, `seg_1` and, with `two_emb_layer`,
`seg_bn_1` and `seg_2`.  Activations are ReLU clipped at 20
(Hardtanh(0, 20)) inside the blocks, a plain ReLU after the stem.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import FrameMapNet, _bn2d, _shortcut

__all__ = ["relu20", "AFF", "BasicBlockERes2Net", "BasicBlockERes2NetDiffAFF", "ERes2Net",
           "ERes2Net34_Base", "ERes2Net34_Large", "ERes2Net34_aug"]


def relu20(x: torch.Tensor) -> torch.Tensor:
    """Hardtanh(0, 20): the reference's clipped ReLU."""
    return F.hardtanh(x, 0.0, 20.0)


def _conv3x3(planes: int) -> nn.Conv2d:
    return nn.Conv2d(planes, planes, 3, padding=1, bias=False)


class AFF(nn.Module):
    """Attentional feature fusion: g = 1 + tanh(MLP([x, y])) from a 1x1
    bottleneck of channels / r; x * g + y * (2 - g)."""

    def __init__(self, channels: int, r: int = 4):
        super().__init__()
        inter = channels // r
        self.local_att = nn.Sequential(
            nn.Conv2d(channels * 2, inter, 1), _bn2d(inter), nn.SiLU(),
            nn.Conv2d(inter, channels, 1), _bn2d(channels))

    def forward(self, x, ds_y):
        g = 1.0 + torch.tanh(self.local_att(torch.cat([x, ds_y], dim=1)))
        return x * g + ds_y * (2.0 - g)


class _Block(nn.Module):
    """The parts both ERes2Net blocks share: the strided 1x1 into `scale`
    splits, the 1x1 expansion, the shortcut and the clipped ReLU."""

    def __init__(self, in_planes: int, planes: int, stride: int, base_width: int, scale: int,
                 expansion: int):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0)))
        out_planes = planes * expansion
        self.width = width
        self.conv1 = nn.Conv2d(in_planes, width * scale, 1, stride=stride, bias=False)
        self.bn1 = _bn2d(width * scale)
        self._splits_init(width, scale)
        self.conv3 = nn.Conv2d(width * scale, out_planes, 1, bias=False)
        self.bn3 = _bn2d(out_planes)
        self.shortcut = _shortcut(in_planes, out_planes, stride)

    def forward(self, x):
        spx = torch.split(relu20(self.bn1(self.conv1(x))), self.width, 1)
        out = self.bn3(self.conv3(torch.cat(self._splits(spx), dim=1)))
        return relu20(out + self.shortcut(x))


class BasicBlockERes2Net(_Block):
    """Every split through a 3x3 conv, each fed the previous conv's output
    plus its own split."""

    def _splits_init(self, width, scale):
        self.convs = nn.ModuleList(_conv3x3(width) for _ in range(scale))
        self.bns = nn.ModuleList(_bn2d(width) for _ in range(scale))

    def _splits(self, spx):
        outs = []
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = spx[0] if i == 0 else sp + spx[i]
            sp = relu20(bn(conv(sp)))
            outs.append(sp)
        return outs


class BasicBlockERes2NetDiffAFF(_Block):
    """The first split through `conv2_1`; each later one fused to the
    running output by an AFF before its 3x3 conv."""

    def _splits_init(self, width, scale):
        self.conv2_1 = _conv3x3(width)
        self.bn2_1 = _bn2d(width)
        self.convs = nn.ModuleList(_conv3x3(width) for _ in range(scale - 1))
        self.bns = nn.ModuleList(_bn2d(width) for _ in range(scale - 1))
        self.fuse_models = nn.ModuleList(AFF(width) for _ in range(scale - 1))

    def _splits(self, spx):
        sp = relu20(self.bn2_1(self.conv2_1(spx[0])))
        outs = [sp]
        for i, (conv, bn, fuse) in enumerate(zip(self.convs, self.bns, self.fuse_models)):
            sp = relu20(bn(conv(fuse(sp, spx[i + 1]))))
            outs.append(sp)
        return outs


class ERes2Net(FrameMapNet):
    def __init__(self, m_channels: int, num_blocks: Sequence[int], base_width: int = 32,
                 scale: int = 2, expansion: int = 2, feat_dim: int = 80, embed_dim: int = 192,
                 pooling_func: str = "TSTP", two_emb_layer: bool = False):
        super().__init__()
        mc = m_channels
        self.conv1 = nn.Conv2d(1, mc, 3, padding=1, bias=False)
        self.bn1 = _bn2d(mc)
        in_planes = mc
        for li, (mult, stride) in enumerate(zip((1, 2, 4, 8), (1, 2, 2, 2))):
            block = BasicBlockERes2Net if li < 2 else BasicBlockERes2NetDiffAFF
            blocks = []
            for bi in range(num_blocks[li]):
                blocks.append(block(in_planes, mc * mult, stride if bi == 0 else 1, base_width,
                                    scale, expansion))
                in_planes = mc * mult * expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        for i in (1, 2, 3):  # stage i's fused map, strided to stage i + 1's
            c = mc * expansion * 2 ** (i - 1)
            setattr(self, f"layer{i}_downsample",
                    nn.Conv2d(c, 2 * c, 3, stride=2, padding=1, bias=False))
        self.fuse_mode12 = AFF(mc * expansion * 2)
        self.fuse_mode123 = AFF(mc * expansion * 4)
        self.fuse_mode1234 = AFF(mc * expansion * 8)
        self._init_head(feat_dim, in_planes, embed_dim, pooling_func, two_emb_layer)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        out = F.relu(self.bn1(self.conv1(x.transpose(1, 2).unsqueeze(1))))
        out1 = self.layer1(out)
        out2 = self.layer2(out1)
        fuse12 = self.fuse_mode12(out2, self.layer1_downsample(out1))
        out3 = self.layer3(out2)
        fuse123 = self.fuse_mode123(out3, self.layer2_downsample(fuse12))
        out4 = self.layer4(out3)
        fuse1234 = self.fuse_mode1234(out4, self.layer3_downsample(fuse123))
        return self._head(fuse1234, mask)


def ERes2Net34_Base(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return ERes2Net(32, (3, 4, 6, 3), feat_dim=feat_dim, embed_dim=embed_dim,
                    pooling_func=pooling_func, two_emb_layer=two_emb_layer)


def ERes2Net34_Large(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False, **kw):
    return ERes2Net(64, (3, 4, 6, 3), feat_dim=feat_dim, embed_dim=embed_dim,
                    pooling_func=pooling_func, two_emb_layer=two_emb_layer)


def ERes2Net34_aug(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False,
                   expansion=4, base_width=24, scale=3, **kw):
    return ERes2Net(64, (3, 4, 6, 3), base_width=base_width, scale=scale,
                    expansion=expansion, feat_dim=feat_dim, embed_dim=embed_dim,
                    pooling_func=pooling_func, two_emb_layer=two_emb_layer)
