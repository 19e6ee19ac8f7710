"""Model registry: name -> factory returning an nn.Module backbone.

Counterpart of `wespeaker_hubert_tpu/models/registry.py` for the families
ported so far: ECAPA-TDNN, ResNet, Res2Net, ERes2Net, CAM++ and the
Whisper-PMFA head (ROADMAP.md queue 1, item 2 lists the rest).  Factories
share the signature (feat_dim, embed_dim, pooling_func, **kwargs), and the
module is called as module(x, mask=None) with x = (B, T, feat_dim)
features.
"""

from __future__ import annotations

from typing import Callable, Dict

from . import campplus, ecapa_tdnn, eres2net, res2net, resnet, whisper_pmfa

__all__ = ["get_speaker_model", "embedding_from_outputs", "MODEL_REGISTRY"]

MODEL_REGISTRY: Dict[str, Callable] = {
    "ECAPA_TDNN_c512": ecapa_tdnn.ECAPA_TDNN_c512,
    "ECAPA_TDNN_GLOB_c512": ecapa_tdnn.ECAPA_TDNN_GLOB_c512,
    "ECAPA_TDNN_c1024": ecapa_tdnn.ECAPA_TDNN_c1024,
    "ECAPA_TDNN_GLOB_c1024": ecapa_tdnn.ECAPA_TDNN_GLOB_c1024,
    "ResNet18": resnet.ResNet18,
    "ResNet34": resnet.ResNet34,
    "ResNet50": resnet.ResNet50,
    "ResNet101": resnet.ResNet101,
    "ResNet152": resnet.ResNet152,
    "ResNet221": resnet.ResNet221,
    "ResNet293": resnet.ResNet293,
    "Res2Net34_Base": res2net.Res2Net34_Base,
    "Res2Net34_Large": res2net.Res2Net34_Large,
    "ERes2Net34_Base": eres2net.ERes2Net34_Base,
    "ERes2Net34_Large": eres2net.ERes2Net34_Large,
    "ERes2Net34_aug": eres2net.ERes2Net34_aug,
    "CAMPPlus": campplus.CAMPPlus,
    "whisper_PMFA": whisper_pmfa.whisper_PMFA,
    "whisper_PMFA_large_v2": whisper_pmfa.whisper_PMFA_large_v2,
}


def get_speaker_model(model_name: str) -> Callable:
    try:
        return MODEL_REGISTRY[model_name]
    except KeyError:
        pass
    # case-insensitive fallback: reference configs are not consistent about
    # casing
    lowered = {k.lower(): v for k, v in MODEL_REGISTRY.items()}
    if model_name.lower() in lowered:
        return lowered[model_name.lower()]
    raise ValueError(
        f"unknown model {model_name!r}; available: "
        + ", ".join(sorted(MODEL_REGISTRY))
    ) from None


def embedding_from_outputs(outputs):
    """Backbones return either `embed` or `(..., embed)`; take the last."""
    if isinstance(outputs, (tuple, list)):
        return outputs[-1]
    return outputs
