"""Batched feature post-processing: CMVN.

Counterpart of `wespeaker_hubert_tpu/ops/feature_utils.py` (CMN over the
time axis, with an optional valid-length mask for padded batches).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["apply_cmvn"]


def apply_cmvn(
    feats: torch.Tensor,
    norm_mean: bool = True,
    norm_var: bool = False,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-utterance cepstral mean (and optional variance) normalization.

    feats: (B, T, F).  With `lengths` (B,), statistics are computed over the
    valid prefix only and frames past it are zeroed.  Statistics are taken
    in float32; the output keeps the input dtype.
    """
    dt = feats.dtype
    f32 = feats.float()
    if lengths is None:
        if norm_mean:
            feats = (f32 - f32.mean(dim=1, keepdim=True)).to(dt)
            f32 = feats.float()
        if norm_var:
            var = f32.var(dim=1, unbiased=False, keepdim=True)
            feats = (f32 / torch.sqrt(var + 1e-7)).to(dt)
        return feats

    t = feats.shape[1]
    lengths = torch.as_tensor(lengths, device=feats.device)
    mask3 = (
        torch.arange(t, device=feats.device)[None, :] < lengths[:, None]
    ).float()[:, :, None]
    denom = torch.clamp_min(lengths.float(), 1.0)[:, None, None]
    mean = (f32 * mask3).sum(dim=1, keepdim=True) / denom
    if norm_mean:
        f32 = (f32 - mean) * mask3
        if norm_var:
            var = (f32**2 * mask3).sum(dim=1, keepdim=True) / denom
            f32 = f32 / torch.sqrt(var + 1e-7)
        return f32.to(dt)
    if norm_var:
        var = ((f32 - mean) ** 2 * mask3).sum(dim=1, keepdim=True) / denom
        f32 = f32 / torch.sqrt(var + 1e-7)
    return (f32 * mask3).to(dt)
