"""SpeakerNet: the optional SSL frontend and the backbone behind one
embedding entry point.

Counterpart of `wespeaker_hubert_tpu/models/speaker_net.py`.  The
margin-softmax projection belongs to the training slice, so `embed` is the
whole backbone.  A state_dict in the port's names follows WeSpeaker's
layout: the backbone's keys unprefixed, the frontend's under `frontend.`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from .registry import embedding_from_outputs, get_speaker_model

__all__ = ["SpeakerNet", "build_speaker_net", "load_speaker_state"]

FRONTEND_PREFIX = "frontend."


class SpeakerNet(nn.Module):
    def __init__(self, backbone: nn.Module, frontend: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        self.frontend = frontend

    def features(
        self, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The SSL frontend: raw wav -> (feats, feat_lengths)."""
        assert self.frontend is not None
        return self.frontend(wav, lengths=lengths)

    def embed(
        self, feats: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return embedding_from_outputs(self.backbone(feats, mask=mask))

    forward = embed


def build_speaker_net(config: dict) -> SpeakerNet:
    """Frontend (optional) and backbone from a training config (the YAML
    schema as a dict), as the JAX package's bin/train.py:build_speaker_net
    assembles them."""
    from ..frontend import SSLEncoderConfig, frontend_class_dict

    model_args = dict(config.get("model_args", {}))
    dataset_args = config.get("dataset_args", {})
    name = dataset_args.get("frontend", "fbank")
    if name not in frontend_class_dict:
        raise ValueError(f"unknown frontend {name!r}; available: {sorted(frontend_class_dict)}")
    frontend = None
    if name == "s3prl":
        s3prl_args = dataset_args.get("s3prl_args", {})
        enc_cfg = getattr(SSLEncoderConfig, s3prl_args.get("upstream", "wavlm_large"))()
        overrides = {k: s3prl_args[k] for k in ("attn_impl", "gelu_impl") if k in s3prl_args}
        enc_cfg = dataclasses.replace(enc_cfg, **overrides)
        frontend = frontend_class_dict[name](
            enc_cfg,
            frozen=s3prl_args.get("frozen", True),
            layer=s3prl_args.get("layer", -1),
            multilayer_feature=s3prl_args.get("multilayer_feature", True),
        )
        model_args["feat_dim"] = enc_cfg.hidden_size
    elif name != "fbank":
        frontend_class_dict[name](**dataset_args.get(f"{name}_args", {}))
    return SpeakerNet(get_speaker_model(config["model"])(**model_args), frontend)


def load_speaker_state(
    net: SpeakerNet, state: Dict[str, torch.Tensor]
) -> Tuple[List[str], List[str]]:
    """Load a state_dict in the port's names (backbone keys unprefixed,
    frontend keys under `frontend.`) where names match.  Returns (missing,
    unexpected) keys in the same naming; BatchNorm's `num_batches_tracked`
    is never reported missing."""
    backbone_sd = {k: v for k, v in state.items() if not k.startswith(FRONTEND_PREFIX)}
    frontend_sd = {
        k[len(FRONTEND_PREFIX):]: v for k, v in state.items() if k.startswith(FRONTEND_PREFIX)
    }
    missing, unexpected = net.backbone.load_state_dict(backbone_sd, strict=False)
    missing, unexpected = list(missing), list(unexpected)
    if net.frontend is not None:
        fm, fu = net.frontend.load_state_dict(frontend_sd, strict=False)
        missing += [FRONTEND_PREFIX + k for k in fm]
        unexpected += [FRONTEND_PREFIX + k for k in fu]
    else:
        unexpected += [FRONTEND_PREFIX + k for k in frontend_sd]
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    return missing, unexpected
