"""JAX (flax) variables -> the port's PyTorch state_dict.

Carries weights trained or initialized by the JAX package into the port's
modules.  The input is the flax `{'params', 'batch_stats'}` tree as numpy
arrays, of a bare backbone or of a `SpeakerNet` (whose backbone sits under
'backbone', and its SSL frontend under 'frontend'); the output uses the
WeSpeaker names of the port's modules: the backbone's keys unprefixed, the
frontend's under `frontend.` with HuggingFace's encoder names
(`frontend.upstream.encoder.layers.0.attention.q_proj.weight`, ...) and
`frontend.featurizer_weights` (`frontend_from_jax` is the inverse of the
JAX package's `frontend/convert.py:convert_hf_state_dict`), and a
SpeakerNet's margin head under `projection.` in WeSpeaker's layout.

Layout rules:
  Conv    kernel (K, Cin, Cout)  -> weight (Cout, Cin, K)
  Dense   kernel (in, out)       -> weight (out, in), or (out, in, 1) where
                                    the port holds it as a 1x1 Conv1d
  BN      scale / bias + batch_stats mean / var
                                 -> weight / bias / running_mean / running_var
  head    projection/weight (D, C) -> projection.weight (C, D)
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["from_jax_variables", "frontend_from_jax"]

# flax module names inside an ECAPA SE-Res2 block -> torch module paths
_SE_RES2 = {"conv1": "0", "res2": "1", "conv2": "2", "se": "3"}
# torch modules that are 1x1 Conv1d where flax has a Dense
_CONV1X1_DENSE = ("pool.linear1", "pool.linear2")


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _ecapa_module(path: Tuple[str, ...]) -> str:
    """flax module path -> torch module name."""
    parts = list(path)
    if parts[0] in ("layer2", "layer3", "layer4") and len(parts) > 1:
        head = [parts[0], "se_res2block", _SE_RES2[parts[1]]]
        rest = parts[2:]
        if parts[1] == "res2":
            kind, idx = rest[0].rsplit("_", 1)  # conv_3 -> convs.3
            rest = [f"{kind}s", idx] + rest[1:]
        parts = head + rest
    return ".".join(parts)


# flax module names of SSLEncoder -> HF module paths
_SSL_TOP = {
    "feat_proj_layer_norm": "feature_projection.layer_norm",
    "feat_projection": "feature_projection.projection",
    "encoder_layer_norm": "encoder.layer_norm",
}


def _ssl_module(path: Tuple[str, ...]) -> str:
    head, rest = path[0], list(path[1:])
    if head == "feature_extractor":  # conv_3 / norm_3
        kind, idx = rest[0].rsplit("_", 1)
        sub = "conv" if kind == "conv" else "layer_norm"
        return f"feature_extractor.conv_layers.{idx}.{sub}"
    if head == "pos_conv_embed":
        return "encoder.pos_conv_embed." + ".".join(rest)
    if head.startswith("layer_"):
        return f"encoder.layers.{head[len('layer_'):]}." + ".".join(rest)
    return _SSL_TOP[head]


def frontend_from_jax(params: Dict) -> Dict[str, np.ndarray]:
    """JAX SSLFrontend params {'upstream': ..., 'featurizer_weights'} ->
    the port's SSLFrontend state_dict (HF encoder names under `upstream.`)."""
    sd: Dict[str, np.ndarray] = {}
    for path, leaf in _flatten(params.get("upstream", {})).items():
        module, name = _ssl_module(path[:-1]), path[-1]
        if name == "gru_rel_pos_const":
            sd[f"upstream.{module}.{name}"] = leaf
        elif name == "rel_attn_embed":  # (num_buckets, h), an nn.Embedding
            sd[f"upstream.{module}.rel_attn_embed.weight"] = leaf
        elif name == "kernel":
            # conv (k, in/g, out) -> (out, in/g, k); dense (in, out) -> (out, in)
            sd[f"upstream.{module}.weight"] = (
                leaf.transpose(2, 1, 0) if leaf.ndim == 3 else leaf.T
            )
        elif name == "scale":
            sd[f"upstream.{module}.weight"] = leaf
        elif name == "bias":
            sd[f"upstream.{module}.bias"] = leaf
        else:
            raise KeyError(f"unexpected flax frontend parameter {'/'.join(path)}")
    if "featurizer_weights" in params:
        sd["featurizer_weights"] = np.asarray(params["featurizer_weights"])
    return sd


def from_jax_variables(model_name: str, variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX `{'params', 'batch_stats'}` of an ECAPA model, or of a SpeakerNet
    with one, -> state_dict of the port's module of the same name (with the
    SpeakerNet's frontend under `frontend.`)."""
    if not model_name.upper().startswith("ECAPA_TDNN"):
        raise NotImplementedError(f"no JAX converter for {model_name!r} yet")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    frontend: Dict[str, np.ndarray] = {}
    head: Dict[str, np.ndarray] = {}
    if "backbone" in params:  # SpeakerNet
        if "frontend" in params:
            frontend = frontend_from_jax(params["frontend"])
        proj = params.get("projection", {})
        if set(proj) == {"weight"}:  # the margin heads; other heads are not ported
            head["projection.weight"] = np.asarray(proj["weight"]).T
        params = params["backbone"]
        stats = stats.get("backbone", {})

    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params).items():
        module, name = _ecapa_module(path[:-1]), path[-1]
        if name == "kernel":
            if leaf.ndim == 3:
                w = leaf.transpose(2, 1, 0)
            elif module in _CONV1X1_DENSE:
                w = leaf.T[:, :, None]
            else:
                w = leaf.T
            sd[f"{module}.weight"] = w
        elif name == "scale":
            sd[f"{module}.weight"] = leaf
        elif name == "bias":
            sd[f"{module}.bias"] = leaf
        else:
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
    for path, leaf in _flatten(stats).items():
        module, name = _ecapa_module(path[:-1]), path[-1]
        if name not in ("mean", "var"):
            raise KeyError(f"unexpected flax batch stat {'/'.join(path)}")
        sd[f"{module}.running_{name}"] = leaf
        sd[f"{module}.num_batches_tracked"] = np.zeros((), np.int64)
    sd.update({f"frontend.{k}": v for k, v in frontend.items()})
    sd.update(head)
    return {
        k: torch.from_numpy(
            np.asarray(v, np.int64 if k.endswith("tracked") else np.float32).copy()
        )
        for k, v in sd.items()
    }
