"""RepVGG speaker backbones with structural reparameterization, in PyTorch.

Counterpart of `wespeaker_hubert_tpu/models/repvgg.py`, in WeSpeaker's
names and NCHW (B, C, F, T) layout (reference wespeaker/models/repvgg.py):
`stage0` and `stage{1..4}.{i}` blocks, each in the training form
`rbr_dense` (3x3 conv + BatchNorm, `.conv` / `.bn`), `rbr_1x1` (1x1 conv +
BatchNorm; RepVGGBlock) or `rbr_dense_dilation` (dilated 3x3 conv +
BatchNorm; RepSPKBlock) and `rbr_identity` (a BatchNorm, where the block
keeps its width and stride 1), or in the deploy form `rbr_reparam` (one
biased 3x3, or 5x5 for RepSPK, conv); `se.fc_1` / `se.fc_2` with `use_se`;
the pooling `pool` and `seg`.

Both axes stride by 2 at stages 2-4, so the pooling mask is strided once
per stride-2 stage, then cut to T'.  The frame map flattens channel-major,
as WeSpeaker's does (the JAX module flattens frequency-major; the port's
converter permutes `seg`), but frequency-major for the multi-head poolings
(resnet.py:flatten_frame_map).

`convert_repvgg_params` fuses a training-form state_dict into the deploy
form, as the JAX package's `convert_repvgg_params` fuses its trees: each
branch's conv with its BatchNorm (eps 1e-5), the 1x1 kernel padded to the
centre of a 3x3, the identity BatchNorm as a grouped identity kernel, and
RepSPK's dilated 3x3 scattered into a 5x5.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm import BatchNorm2d
from .pooling import POOLING_LAYERS, pooling_output_dim
from .resnet import downsample_mask, flatten_frame_map, strided_size

__all__ = ["SEBlock2D", "RepVGGBlock", "RepSPKBlock", "RepVGG", "convert_repvgg_params",
           "REPVGG_FACTORIES"]

_OPTIONAL_GROUPWISE = [2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26]
G2_MAP = dict.fromkeys(_OPTIONAL_GROUPWISE, 2)
G4_MAP = dict.fromkeys(_OPTIONAL_GROUPWISE, 4)
FUSE_EPS = 1e-5


def _conv_bn(cin: int, cout: int, kernel: int, stride: int, padding: int, groups: int,
             dilation: int = 1) -> nn.Sequential:
    out = nn.Sequential()
    out.add_module("conv", nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                                     dilation=dilation, groups=groups, bias=False))
    out.add_module("bn", BatchNorm2d(cout, eps=1e-5, momentum=0.1))
    return out


class SEBlock2D(nn.Module):
    """Squeeze-excitation over (F, T)."""

    def __init__(self, channels: int, ratio: int = 4):
        super().__init__()
        self.fc_1 = nn.Linear(channels, channels // ratio)
        self.fc_2 = nn.Linear(channels // ratio, channels)

    def forward(self, x):
        s = torch.sigmoid(self.fc_2(F.relu(self.fc_1(x.mean(dim=(2, 3))))))
        return x * s[:, :, None, None]


class RepVGGBlock(nn.Module):
    """3x3 + 1x1 + identity-BN branches (training form), or one fused 3x3
    conv (deploy form); ReLU, then the optional SE."""

    kernel = 3  # the deploy form's kernel

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, groups: int = 1,
                 deploy: bool = False, use_se: bool = False):
        super().__init__()
        k = self.kernel
        if deploy:
            self.rbr_reparam = nn.Conv2d(in_channels, out_channels, k, stride=stride,
                                         padding=k // 2, groups=groups, bias=True)
        else:
            self.rbr_identity = (BatchNorm2d(in_channels, eps=1e-5, momentum=0.1)
                                 if in_channels == out_channels and stride == 1 else None)
            self._branches(in_channels, out_channels, stride, groups)
        self.se = SEBlock2D(out_channels, 4) if use_se else None

    def _branches(self, cin, cout, stride, groups):
        self.rbr_dense = _conv_bn(cin, cout, 3, stride, 1, groups)
        self.rbr_1x1 = _conv_bn(cin, cout, 1, stride, 0, groups)

    def _train_form(self, x):
        return self.rbr_dense(x) + self.rbr_1x1(x)

    def forward(self, x):
        if hasattr(self, "rbr_reparam"):
            out = self.rbr_reparam(x)
        else:
            out = self._train_form(x)
            if self.rbr_identity is not None:
                out = out + self.rbr_identity(x)
        out = F.relu(out)
        return out if self.se is None else self.se(out)


class RepSPKBlock(RepVGGBlock):
    """RSBB: 3x3 + dilated 3x3 + identity-BN branches (training form), or one
    fused 5x5 conv (deploy form)."""

    kernel = 5

    def _branches(self, cin, cout, stride, groups):
        self.rbr_dense = _conv_bn(cin, cout, 3, stride, 1, groups)
        self.rbr_dense_dilation = _conv_bn(cin, cout, 3, stride, 2, groups, dilation=2)

    def _train_form(self, x):
        return self.rbr_dense(x) + self.rbr_dense_dilation(x)


class RepVGG(nn.Module):
    """(B, T, feat_dim) features -> (B, embed_dim) embedding."""

    def __init__(self, num_blocks: Sequence[int], strides: Sequence[int],
                 width_multiplier: Sequence[float], block: str = "RepVGG",
                 override_groups_map: Optional[Dict[int, int]] = None, base_width: int = 64,
                 feat_dim: int = 80, embed_dim: int = 256, pooling_func: str = "TSTP",
                 deploy: bool = False, use_se: bool = False):
        super().__init__()
        self.feat_dim = feat_dim
        self.embed_dim = embed_dim
        wm = [w * (base_width / 64.0) for w in width_multiplier]
        groups_map = override_groups_map or {}
        blk = RepSPKBlock if block == "RepSPK" else RepVGGBlock
        in_planes = min(64, int(64 * wm[0]))
        self.stage0 = blk(1, in_planes, strides[0], deploy=deploy, use_se=use_se)
        layer_idx = 1
        widths = [int(64 * wm[0]), int(128 * wm[1]), int(256 * wm[2]), int(512 * wm[3])]
        for si, (planes, n) in enumerate(zip(widths, num_blocks)):
            stride = strides[si + 1]
            blocks = []
            for bi in range(n):
                blocks.append(blk(in_planes, planes, stride if bi == 0 else 1,
                                  groups_map.get(layer_idx, 1), deploy, use_se))
                in_planes = planes
                layer_idx += 1
            setattr(self, f"stage{si + 1}", nn.Sequential(*blocks))
        # both axes halve at each stride-2 stage
        self.time_strides = sum(1 for s in strides if s == 2)
        stats_dim = in_planes * strided_size(feat_dim, self.time_strides)
        self.pooling_func = pooling_func
        self.pool = POOLING_LAYERS[pooling_func](in_dim=stats_dim)
        self.seg = nn.Linear(pooling_output_dim(pooling_func, stats_dim), embed_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        out = self.stage0(x.transpose(1, 2).unsqueeze(1))  # (B, 1, F, T)
        out = self.stage4(self.stage3(self.stage2(self.stage1(out))))
        if mask is not None:
            mask = downsample_mask(mask, out.shape[-1], self.time_strides)
        return self.seg(self.pool(flatten_frame_map(out, self.pooling_func), mask))


# ---------------------------------------------------------------- convert
def _fuse_conv_bn(weight: torch.Tensor, sd: Dict[str, torch.Tensor], bn: str):
    """(out, in/g, k, k) kernel and the BatchNorm `bn` of `sd` -> the fused
    kernel and bias."""
    std = torch.sqrt(sd[f"{bn}.running_var"] + FUSE_EPS)
    t = sd[f"{bn}.weight"] / std
    return weight * t[:, None, None, None], sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * t


def _identity_kernel(channels: int, in_per_group: int, k: int) -> torch.Tensor:
    """The grouped identity as an (out, in/g, k, k) kernel, 1 at the centre."""
    w = torch.zeros(channels, in_per_group, k, k)
    idx = torch.arange(channels)
    w[idx, idx % in_per_group, k // 2, k // 2] = 1.0
    return w


def _pad_center(w: torch.Tensor, to: int) -> torch.Tensor:
    pad = (to - w.shape[-1]) // 2
    return F.pad(w, (pad, pad, pad, pad))


def _dilate_3x3_to_5x5(w: torch.Tensor) -> torch.Tensor:
    """A dilation-2 3x3 kernel as the 5x5 with its taps at 0, 2, 4."""
    out = w.new_zeros(w.shape[:2] + (5, 5))
    out[:, :, ::2, ::2] = w
    return out


def convert_repvgg_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A training-form RepVGG / RepSPK state_dict -> the deploy form's, which
    loads into the same architecture built with `deploy=True`: every block's
    branches fused into `rbr_reparam` (the module doc); the SE, `pool` and
    `seg` as they are."""
    sd = {k: v.detach().float().cpu() for k, v in state_dict.items()}
    blocks = sorted(k[:-len(".rbr_dense.conv.weight")] for k in sd
                    if k.endswith(".rbr_dense.conv.weight"))
    branches = (".rbr_dense.", ".rbr_1x1.", ".rbr_dense_dilation.", ".rbr_identity.")
    out = {k: v for k, v in sd.items()
           if not any(k.startswith(b + br) for b in blocks for br in branches)}
    for b in blocks:
        dense = sd[f"{b}.rbr_dense.conv.weight"]
        spk = f"{b}.rbr_dense_dilation.conv.weight" in sd
        target = 5 if spk else 3
        kernel, bias = _fuse_conv_bn(dense, sd, f"{b}.rbr_dense.bn")
        kernel = _pad_center(kernel, target)
        if spk:
            k2, b2 = _fuse_conv_bn(sd[f"{b}.rbr_dense_dilation.conv.weight"], sd,
                                   f"{b}.rbr_dense_dilation.bn")
            k2 = _dilate_3x3_to_5x5(k2)
        else:
            k2, b2 = _fuse_conv_bn(sd[f"{b}.rbr_1x1.conv.weight"], sd, f"{b}.rbr_1x1.bn")
            k2 = _pad_center(k2, 3)
        kernel, bias = kernel + k2, bias + b2
        if f"{b}.rbr_identity.weight" in sd:
            ki, bi = _fuse_conv_bn(_identity_kernel(dense.shape[0], dense.shape[1], target), sd,
                                   f"{b}.rbr_identity")
            kernel, bias = kernel + ki, bias + bi
        out[f"{b}.rbr_reparam.weight"] = kernel
        out[f"{b}.rbr_reparam.bias"] = bias
    return out


def _factory(num_blocks, strides, wm, block="RepVGG", og=None):
    def make(feat_dim, embed_dim, pooling_func="TSTP", deploy=False, use_se=False, **kw):
        return RepVGG(num_blocks, strides, wm, block, og, feat_dim=feat_dim,
                      embed_dim=embed_dim, pooling_func=pooling_func, deploy=deploy,
                      use_se=use_se)

    return make


_S = (1, 1, 2, 2, 2)
REPVGG_FACTORIES = {
    "REPVGG_TINY_A0": _factory((3, 4, 23, 3), _S, (0.5, 0.5, 0.5, 0.5)),
    "REPVGG_TINY_RSBB_A0": _factory((3, 4, 23, 3), _S, (0.5, 0.5, 0.5, 0.5), "RepSPK"),
    "REPVGG_A0": _factory((2, 4, 14, 1), _S, (0.75, 0.75, 0.75, 2.5)),
    "REPVGG_RSBB_A0": _factory((2, 4, 14, 1), _S, (0.75, 0.75, 0.75, 2.5), "RepSPK"),
    "REPVGG_A1": _factory((2, 4, 14, 1), _S, (1, 1, 1, 2.5)),
    "REPVGG_A2": _factory((2, 4, 14, 1), _S, (1.5, 1.5, 1.5, 2.75)),
    "REPVGG_RSBB_A2": _factory((2, 4, 14, 1), _S, (1.5, 1.5, 1.5, 2.75), "RepSPK"),
    "REPVGG_B0": _factory((4, 6, 16, 1), _S, (1, 1, 1, 2.5)),
    "REPVGG_RSBB_B0": _factory((4, 6, 16, 1), _S, (1, 1, 1, 2.5), "RepSPK"),
    "REPVGG_B1": _factory((4, 6, 16, 1), _S, (2, 2, 2, 4)),
    "REPVGG_B1g2": _factory((4, 6, 16, 1), _S, (2, 2, 2, 4), og=G2_MAP),
    "REPVGG_B1g4": _factory((4, 6, 16, 1), _S, (2, 2, 2, 4), og=G4_MAP),
    "REPVGG_B2": _factory((4, 6, 16, 1), _S, (2.5, 2.5, 2.5, 5)),
    "REPVGG_B2g2": _factory((4, 6, 16, 1), _S, (2.5, 2.5, 2.5, 5), og=G2_MAP),
    "REPVGG_B2g4": _factory((4, 6, 16, 1), _S, (2.5, 2.5, 2.5, 5), og=G4_MAP),
    "REPVGG_B3": _factory((4, 6, 16, 1), _S, (3, 3, 3, 5)),
    "REPVGG_B3g2": _factory((4, 6, 16, 1), _S, (3, 3, 3, 5), og=G2_MAP),
    "REPVGG_B3g4": _factory((4, 6, 16, 1), _S, (3, 3, 3, 5), og=G4_MAP),
    "REPVGG_D2SE": _factory((8, 14, 24, 1), _S, (2.5, 2.5, 2.5, 5), og=G4_MAP),
}
