"""Batched feature post-processing: CMVN and SpecAugment.

Counterpart of `wespeaker_hubert_tpu/ops/feature_utils.py`: CMN over the
time axis, with an optional valid-length mask for padded batches, and
per-sample SpecAugment time / frequency masks.  SpecAugment draws from a
`torch.Generator` (the JAX package draws from jax.random, whose numbers
torch cannot reproduce), so it is split: `spec_aug_masks` draws the masks
and the gate, `apply_spec_aug` applies masks handed to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["apply_cmvn", "apply_spec_aug", "spec_aug", "spec_aug_masks"]


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


def _band_mask(size: int, max_width: int, b: int, generator, device) -> torch.Tensor:
    """(b, size) float mask, 0 inside a band of start ~ U[0, size - 1] and
    width ~ U[1, max_width], per sample."""
    start = torch.randint(0, size, (b, 1), generator=generator, device=device)
    width = torch.randint(1, max_width + 1, (b, 1), generator=generator, device=device)
    pos = torch.arange(size, device=device)[None, :]
    return 1.0 - ((pos >= start) & (pos < start + width)).float()


def spec_aug_masks(
    b: int,
    t: int,
    f: int,
    generator: Optional[torch.Generator] = None,
    num_t_mask: int = 1,
    num_f_mask: int = 1,
    max_t: int = 10,
    max_f: int = 8,
    prob: float = 0.6,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample SpecAugment draws: a (B, T, F) float32 mask (time bands,
    then frequency bands) and a (B,) bool gate, True with probability
    `prob`."""
    mask = torch.ones((b, t, f), device=device)
    for _ in range(num_t_mask):
        mask = mask * _band_mask(t, max_t, b, generator, device)[:, :, None]
    for _ in range(num_f_mask):
        mask = mask * _band_mask(f, max_f, b, generator, device)[:, None, :]
    gate = torch.rand((b,), generator=generator, device=device) < prob
    return mask, gate


def apply_spec_aug(feats: torch.Tensor, mask: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """feats (B, T, F) times `mask` in the rows where `gate` is set."""
    return torch.where(gate[:, None, None], feats * mask.to(feats.dtype), feats)


def spec_aug(
    feats: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_t_mask: int = 1,
    num_f_mask: int = 1,
    max_t: int = 10,
    max_f: int = 8,
    prob: float = 0.6,
) -> torch.Tensor:
    """SpecAugment time / frequency masking of a (B, T, F) batch, drawn per
    sample from `generator` (which must live on feats' device)."""
    b, t, f = feats.shape
    mask, gate = spec_aug_masks(b, t, f, generator, num_t_mask, num_f_mask, max_t, max_f,
                                prob, device=feats.device)
    return apply_spec_aug(feats, mask, gate)
