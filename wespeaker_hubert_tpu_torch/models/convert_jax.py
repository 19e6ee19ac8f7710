"""JAX (flax) variables -> the port's PyTorch state_dict.

Carries weights trained or initialized by the JAX package into the port's
modules.  The input is the flax `{'params', 'batch_stats'}` tree as numpy
arrays, of a bare backbone or of a `SpeakerNet` (whose backbone sits under
'backbone'); the output uses the WeSpeaker names of the port's modules.

Layout rules:
  Conv    kernel (K, Cin, Cout)  -> weight (Cout, Cin, K)
  Dense   kernel (in, out)       -> weight (out, in), or (out, in, 1) where
                                    the port holds it as a 1x1 Conv1d
  BN      scale / bias + batch_stats mean / var
                                 -> weight / bias / running_mean / running_var
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["from_jax_variables"]

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


def from_jax_variables(model_name: str, variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX `{'params', 'batch_stats'}` of an ECAPA model -> state_dict of the
    port's module of the same name."""
    if not model_name.upper().startswith("ECAPA_TDNN"):
        raise NotImplementedError(f"no JAX converter for {model_name!r} yet")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if "backbone" in params:  # SpeakerNet
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
    return {
        k: torch.from_numpy(
            np.asarray(v, np.int64 if k.endswith("tracked") else np.float32).copy()
        )
        for k, v in sd.items()
    }
