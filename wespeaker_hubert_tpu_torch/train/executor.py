"""Eval-side executor: batched, masked embedding extraction.

Counterpart of the eval half of `wespeaker_hubert_tpu/train/executor.py`
(`make_eval_embed`, with its SSL-frontend branch, and
`cast_variables_bf16`).  The train step is a later slice of the port.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..ops.feature_utils import apply_cmvn
from ..ops.pipeline import FeaturePipelineConfig, wav_to_features

__all__ = ["make_eval_embed", "cast_variables_bf16"]


def cast_variables_bf16(model: torch.nn.Module) -> torch.nn.Module:
    """Cast every float32 parameter and buffer to bf16, BatchNorm running
    statistics included, as the JAX function casts every f32 leaf; the
    companion of compute_dtype=torch.bfloat16.  Casts in place and returns
    the module."""
    return model.to(torch.bfloat16)


def make_eval_embed(
    model: torch.nn.Module,
    feature_cfg: Optional[FeaturePipelineConfig] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Embedding extraction: batch -> (B, emb_dim) float32.

    Batch: {'wav': (B, W), 'length': (B,)} or {'feat': (B, T, F),
    'feat_length': (B,)}, on the model's device; lengths are optional.
    Padded batches are exact: CMN and pooling only see valid frames.  A
    SpeakerNet with a frontend takes the wav (cast to `compute_dtype`)
    through it, then CMVN over the valid frames.
    """
    fcfg = feature_cfg or FeaturePipelineConfig()
    use_frontend = getattr(model, "frontend", None) is not None

    def embed_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            if "feat" in batch:
                lengths = batch.get("feat_length")
                feats = apply_cmvn(
                    batch["feat"],
                    norm_mean=fcfg.cmvn_norm_mean,
                    norm_var=fcfg.cmvn_norm_var,
                    lengths=lengths,
                )
                mask = None
                if lengths is not None:
                    t = feats.shape[1]
                    mask = (
                        torch.arange(t, device=feats.device)[None, :]
                        < lengths[:, None]
                    )
            elif use_frontend:
                wav = batch["wav"]
                if compute_dtype is not None:
                    wav = wav.to(compute_dtype)
                feats, feat_lengths = model.features(wav, lengths=batch.get("length"))
                feats = apply_cmvn(
                    feats,
                    norm_mean=fcfg.cmvn_norm_mean,
                    norm_var=fcfg.cmvn_norm_var,
                    lengths=feat_lengths,
                )
                mask = None
                if feat_lengths is not None:
                    mask = (
                        torch.arange(feats.shape[1], device=feats.device)[None, :]
                        < feat_lengths[:, None]
                    )
            else:
                feats, mask = wav_to_features(
                    batch["wav"], fcfg, lengths=batch.get("length")
                )
            if compute_dtype is not None:
                feats = feats.to(compute_dtype)
            return model.embed(feats, mask=mask).float()

    return embed_fn
