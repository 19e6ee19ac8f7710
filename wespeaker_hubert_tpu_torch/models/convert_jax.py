"""JAX (flax) variables -> the port's PyTorch state_dict.

Carries weights trained or initialized by the JAX package into the port's
modules, for the families the port has: ECAPA-TDNN and ResNet.  The input is
the flax `{'params', 'batch_stats'}` tree as numpy arrays (a JAX `.ckpt`
holds one, utils/checkpoint.py:load_jax_checkpoint), of a bare backbone or
of a `SpeakerNet` (whose backbone sits under
'backbone', and its SSL frontend under 'frontend'); the output uses the
WeSpeaker names of the port's modules: the backbone's keys unprefixed, the
frontend's under `frontend.` with HuggingFace's encoder names
(`frontend.upstream.encoder.layers.0.attention.q_proj.weight`, ...) and
`frontend.featurizer_weights` (`frontend_from_jax` is the inverse of the
JAX package's `frontend/convert.py:convert_hf_state_dict`), and a
SpeakerNet's margin head under `projection.` in WeSpeaker's layout.

Layout rules:
  Conv1d  kernel (K, Cin, Cout)  -> weight (Cout, Cin, K)
  Conv2d  kernel (kT, kF, Cin, Cout) (flax NHWC over (T, F))
                                 -> weight (Cout, Cin, kF, kT) (torch NCHW
                                    over (F, T))
  Dense   kernel (in, out)       -> weight (out, in), or (out, in, 1) where
                                    the port holds it as a 1x1 Conv1d
  BN      scale / bias + batch_stats mean / var
                                 -> weight / bias / running_mean / running_var
  head    projection/weight (D, C) -> projection.weight (C, D)

ResNet's names: `layer{L}_{i}/conv{k}` -> `layer{L}.{i}.conv{k}`, and
`shortcut_conv` / `shortcut_bn` -> `shortcut.0` / `.1`.  The JAX ResNet
flattens its last frame map (T', F', C') frequency-major before pooling, the
port (C', F', T') channel-major, as WeSpeaker does, so `seg_1`'s input
columns are permuted (the inverse of the JAX package's
`models/convert_torch.py:_stats_permutation`, whose copy is here); that
needs the frequency rows F' = feat_dim // 8, so a ResNet conversion takes
the model's `feat_dim`.
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


def _np(leaf) -> np.ndarray:
    """A leaf as numpy; a bf16 leaf of a JAX checkpoint (a torch tensor,
    utils/flax_msgpack.py) as its exact float32 values."""
    return leaf.float().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = _np(v)
    return out


def _stats_permutation(channels: int, freq: int) -> np.ndarray:
    """For flattened frame-map rows: JAX's index f * C + c -> WeSpeaker's
    c * F + f (a copy of the JAX package's converter's)."""
    f, c = np.divmod(np.arange(channels * freq), channels)
    return c * freq + f


def _resnet_module(path: Tuple[str, ...]) -> str:
    """flax module path -> torch module name (ResNet)."""
    head, rest = path[0], list(path[1:])
    if head.startswith("layer") and "_" in head:  # layer2_0 -> layer2.0
        head = head.replace("_", ".")
        rest = [{"shortcut_conv": "shortcut.0", "shortcut_bn": "shortcut.1"}.get(r, r)
                for r in rest]
    return ".".join([head] + rest)


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
        sd["featurizer_weights"] = _np(params["featurizer_weights"])
    return sd


def from_jax_variables(model_name: str, variables: Dict,
                       feat_dim: int = 80) -> Dict[str, torch.Tensor]:
    """JAX `{'params', 'batch_stats'}` of an ECAPA or ResNet model, or of a
    SpeakerNet with one, -> state_dict of the port's module of the same name
    (with the SpeakerNet's frontend under `frontend.`).  `feat_dim` is the
    model's input width, which ResNet's `seg_1` permutation needs."""
    upper = model_name.upper()
    if upper.startswith("ECAPA_TDNN"):
        module_of = _ecapa_module
    elif upper.startswith("RESNET"):
        module_of = _resnet_module
    else:
        raise NotImplementedError(
            f"{model_name!r}: the port has no module of this family (ROADMAP.md queue 1, "
            "item 6)")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    frontend: Dict[str, np.ndarray] = {}
    head: Dict[str, np.ndarray] = {}
    if "backbone" in params:  # SpeakerNet
        if "frontend" in params:
            frontend = frontend_from_jax(params["frontend"])
        proj = params.get("projection", {})
        if set(proj) == {"weight"}:  # the margin heads; other heads are not ported
            head["projection.weight"] = _np(proj["weight"]).T
        params = params["backbone"]
        stats = stats.get("backbone", {})

    sd: Dict[str, np.ndarray] = {}
    for path, leaf in _flatten(params).items():
        module, name = module_of(path[:-1]), path[-1]
        if name == "kernel":
            if leaf.ndim == 4:
                w = leaf.transpose(3, 2, 1, 0)
            elif leaf.ndim == 3:
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
        module, name = module_of(path[:-1]), path[-1]
        if name not in ("mean", "var"):
            raise KeyError(f"unexpected flax batch stat {'/'.join(path)}")
        sd[f"{module}.running_{name}"] = leaf
        sd[f"{module}.num_batches_tracked"] = np.zeros((), np.int64)
    if module_of is _resnet_module:
        # the last map's channels: the widest conv of layer4
        channels = max(v.shape[0] for k, v in sd.items()
                       if k.startswith("layer4.") and k.endswith(".weight") and v.ndim == 4)
        perm = _stats_permutation(channels, feat_dim // 8)
        w = sd["seg_1.weight"]
        if w.shape[1] % perm.size:
            raise ValueError(f"seg_1 takes {w.shape[1]} inputs, not a multiple of "
                             f"{channels} channels x {feat_dim // 8} frequency rows")
        full = np.concatenate([perm + j * perm.size for j in range(w.shape[1] // perm.size)])
        ref = np.empty_like(w)
        ref[:, full] = w  # JAX column i is WeSpeaker's column full[i]
        sd["seg_1.weight"] = ref
    sd.update({f"frontend.{k}": v for k, v in frontend.items()})
    sd.update(head)
    return {
        k: torch.from_numpy(
            np.asarray(v, np.int64 if k.endswith("tracked") else np.float32).copy()
        )
        for k, v in sd.items()
    }
