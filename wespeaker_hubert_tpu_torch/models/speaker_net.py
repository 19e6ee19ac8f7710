"""SpeakerNet: the optional SSL frontend, the backbone and the optional
margin-softmax projection.

Counterpart of `wespeaker_hubert_tpu/models/speaker_net.py`, with its entry
points:

  * forward(feats, label, margin, mask) -> (embed, logits, aux_loss)  [training]
  * embed(feats, mask)                  -> embedding                  [inference]
  * features(wav, lengths)              -> SSL or Whisper frontend features

A state_dict in the port's names follows WeSpeaker's layout: the backbone's
keys unprefixed, the frontend's under `frontend.`, the projection's under
`projection.` (`speaker_state_dict`, `load_speaker_state`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from .registry import embedding_from_outputs, get_speaker_model

__all__ = ["SpeakerNet", "build_speaker_net", "load_speaker_state", "refuse_model_parallel",
           "speaker_state_dict"]

FRONTEND_PREFIX = "frontend."
PROJECTION_PREFIX = "projection."


class SpeakerNet(nn.Module):
    def __init__(
        self,
        backbone: nn.Module,
        frontend: Optional[nn.Module] = None,
        projection: Optional[nn.Module] = None,
    ):
        super().__init__()
        self.backbone = backbone
        self.frontend = frontend
        self.projection = projection

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

    def forward(
        self,
        feats: torch.Tensor,
        label: torch.Tensor,
        margin=0.0,
        mask: Optional[torch.Tensor] = None,
    ):
        """Training: (embedding, logits, aux loss or None)."""
        assert self.projection is not None, "a SpeakerNet built without num_class has no head"
        emb = self.embed(feats, mask=mask)
        logits, aux = self.projection(emb, label, margin)
        return emb, logits, aux


def refuse_model_parallel(fe_args: dict) -> None:
    """Raise on a frontend's pipeline or sequence parallelism, which the
    port does not have (ROADMAP.md queue 1, model-parallel modes)."""
    asked = {"pipeline_parallel": int(fe_args.get("pipeline_parallel") or 1) > 1,
             "sequence_parallel": bool(fe_args.get("sequence_parallel"))}
    for key in (k for k, v in asked.items() if v):
        raise NotImplementedError(
            f"{key}={fe_args[key]} is not ported: the port runs a frontend on one device "
            "(ROADMAP.md queue 1, model-parallel modes)")


def build_speaker_net(config: dict, num_class: Optional[int] = None) -> SpeakerNet:
    """Frontend (optional), backbone and, given `num_class`, the projection
    from a training config (the YAML schema as a dict), as the JAX
    package's bin/train.py:build_speaker_net assembles them."""
    from ..frontend import SSLEncoderConfig, WhisperEncoderConfig, frontend_class_dict

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
    elif name == "whisper_encoder":
        wargs = dataset_args.get("whisper_encoder_args", {})
        refuse_model_parallel(wargs)
        wcfg = getattr(WhisperEncoderConfig, wargs.get("variant", "large_v2"))()
        overrides = {k: wargs[k] for k in ("attn_impl", "gelu_impl") if k in wargs}
        wcfg = dataclasses.replace(wcfg, **overrides)
        frontend = frontend_class_dict[name](wcfg, frozen=wargs.get("frozen", False))
        model_args["feat_dim"] = wcfg.output_size
    backbone = get_speaker_model(config["model"])(**model_args)
    projection = None
    if num_class is not None:
        from .projections import get_projection

        proj_conf = dict(config.get("projection_args", {}))
        proj_conf.setdefault("embed_dim", model_args.get("embed_dim", 192))
        proj_conf["num_class"] = num_class
        projection = get_projection(proj_conf)
    return SpeakerNet(backbone, frontend, projection)


def speaker_state_dict(net: SpeakerNet) -> Dict[str, torch.Tensor]:
    """The net's state_dict in the port's names (see the module doc)."""
    sd = dict(net.backbone.state_dict())
    for prefix, sub in ((FRONTEND_PREFIX, net.frontend), (PROJECTION_PREFIX, net.projection)):
        if sub is not None:
            sd.update({prefix + k: v for k, v in sub.state_dict().items()})
    return sd


def load_speaker_state(
    net: SpeakerNet, state: Dict[str, torch.Tensor]
) -> Tuple[List[str], List[str]]:
    """Load a state_dict in the port's names (backbone keys unprefixed,
    frontend keys under `frontend.`, projection keys under `projection.`)
    where names match.  Returns (missing, unexpected) keys in the same
    naming; BatchNorm's `num_batches_tracked` is never reported missing."""
    prefixed = (FRONTEND_PREFIX, PROJECTION_PREFIX)
    backbone_sd = {k: v for k, v in state.items() if not k.startswith(prefixed)}
    missing, unexpected = net.backbone.load_state_dict(backbone_sd, strict=False)
    missing, unexpected = list(missing), list(unexpected)
    for prefix, sub in ((FRONTEND_PREFIX, net.frontend), (PROJECTION_PREFIX, net.projection)):
        sub_sd = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        if sub is not None:
            sm, su = sub.load_state_dict(sub_sd, strict=False)
            missing += [prefix + k for k in sm]
            unexpected += [prefix + k for k in su]
        else:
            unexpected += [prefix + k for k in sub_sd]
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    return missing, unexpected
