"""HuggingFace HubertModel / WavLMModel state_dict -> the port's SSLEncoder.

Counterpart of `wespeaker_hubert_tpu/frontend/convert.py`.  The port's
encoder keeps HF's parameter names and layouts, so the conversion only
composes the positional conv's weight norm (`weight_g` / `weight_v`, or
`parametrizations.weight.original0` / `original1`, norm over dims (0, 1))
into a plain weight and drops what the encoder does not have
(`masked_spec_embed`, used only for pretraining masks).
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["convert_hf_state_dict", "load_hf_state_dict"]

_POS = "encoder.pos_conv_embed.conv"
_WEIGHT_NORM = {
    f"{_POS}.weight_g": "g",
    f"{_POS}.weight_v": "v",
    f"{_POS}.parametrizations.weight.original0": "g",
    f"{_POS}.parametrizations.weight.original1": "v",
}
_DROPPED = ("masked_spec_embed",)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF encoder state_dict (tensors or numpy arrays) -> the port's
    SSLEncoder state_dict (float32 tensors)."""
    out: Dict[str, torch.Tensor] = {}
    norm_parts: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        value = torch.as_tensor(value).detach().cpu()
        if key in _WEIGHT_NORM:
            norm_parts[_WEIGHT_NORM[key]] = value.double()
        elif key not in _DROPPED:
            out[key] = value.float() if value.is_floating_point() else value
    if norm_parts:
        if f"{_POS}.weight" in out or set(norm_parts) != {"g", "v"}:
            raise KeyError(f"{_POS}: expected weight, or weight_g and weight_v")
        g, v = norm_parts["g"], norm_parts["v"]
        norm = torch.sqrt(torch.sum(v**2, dim=(0, 1), keepdim=True))
        out[f"{_POS}.weight"] = (g * v / torch.clamp_min(norm, 1e-12)).float()
    return out


def load_hf_state_dict(encoder: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load an HF HubertModel / WavLMModel state_dict into an SSLEncoder;
    a missing or unexpected key raises."""
    encoder.load_state_dict(convert_hf_state_dict(sd), strict=True)
