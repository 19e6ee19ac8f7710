"""JAX (flax) variables -> the port's PyTorch state_dict.

Carries weights trained or initialized by the JAX package into the port's
modules, for every family of the JAX registry: x-vector and xi-vector,
ECAPA-TDNN, ResNet, Res2Net, ERes2Net, CAM++, Gemini DF-ResNet,
SimAM-ResNet, RepVGG, ReDimNet and the Whisper-PMFA head.  The input is the flax
`{'params', 'batch_stats'}` tree as numpy arrays (a JAX `.ckpt` holds one,
utils/checkpoint.py:load_jax_checkpoint), of a bare backbone or of a
`SpeakerNet` (whose backbone sits under 'backbone', and its SSL or Whisper
frontend under 'frontend'); the output
uses the WeSpeaker names of the port's modules: the backbone's keys
unprefixed, the frontend's under `frontend.`, an SSL frontend with
HuggingFace's encoder names
(`frontend.upstream.encoder.layers.0.attention.q_proj.weight`, ...) and
`frontend.featurizer_weights` (`frontend_from_jax` is the inverse of the
JAX package's `frontend/convert.py:convert_hf_state_dict`), a Whisper
encoder with OpenAI's (`frontend.blocks.0.attn.query.weight`, ...;
`whisper_frontend_from_jax`, the inverse of `convert_whisper_state_dict`),
and a SpeakerNet's head (every head of models/projections.py) under
`projection.` in WeSpeaker's layout.

Layout rules:
  Conv1d  kernel (K, Cin, Cout)  -> weight (Cout, Cin, K)
  Conv2d  kernel (kT, kF, Cin, Cout) (flax NHWC over (T, F))
                                 -> weight (Cout, Cin, kF, kT) (torch NCHW
                                    over (F, T))
  Dense   kernel (in, out)       -> weight (out, in), or (out, in, 1) where
                                    the port holds it as a 1x1 Conv1d
  LN      scale / bias           -> weight / bias
  BN      scale / bias + batch_stats mean / var
                                 -> weight / bias / running_mean / running_var
  head    projection/weight (D, C) -> projection.weight (C, D)
          (SphereFace2's bias (1, 1) as it is; LinearProduct's bn / linear
           -> projection.trans.0 / .2)
  MHASTP  pool/head_{h}/att_{i} (Dense) -> pool.heads_att_trans.{h}.att_{i}
          (1x1 Conv1d); MQMHASTP's pool/query_{q}/... -> pool.n_query.{q}...

ResNet's names: `layer{L}_{i}/conv{k}` -> `layer{L}.{i}.conv{k}`, and
`shortcut_conv` / `shortcut_bn` -> `shortcut.0` / `.1`.  The JAX ResNet
flattens its last frame map (T', F', C') frequency-major before pooling, the
port (C', F', T') channel-major, as WeSpeaker does, so `seg_1`'s input
columns are permuted (the inverse of the JAX package's
`models/convert_torch.py:_stats_permutation`, whose copy is here); that
needs the frequency rows F' = feat_dim // 8, so a ResNet conversion takes
the model's `feat_dim`; with a multi-head pooling (MHASTP, MQMHASTP) the
port flattens frequency-major too, and `seg_1` is not permuted.  Res2Net
and ERes2Net follow ResNet's rules, with `convs_{k}` / `bns_{k}` /
`fuse_{k}` -> `convs.{k}` / `bns.{k}` / `fuse_models.{k}` and an AFF's
`att_conv1` / `att_bn1` / `att_conv2` /
`att_bn2` -> `local_att.0` / `.1` / `.3` / `.4` (the inverses of
`res2net_from_torch` and `eres2net_from_torch`).  CAM++ (the inverse of
`campplus_from_torch`) holds every Dense as a 1x1 Conv1d under WeSpeaker's
`xvector.` names, and the first TDNN's input channels, the FCM map
flattened, are permuted as `seg_1`'s columns are.

The rest are the inverses of the JAX package's `xvec_from_torch` (XI's
`lin1` / `bn1` / `lin2` -> `pool.lin1_relu_bn.0` / `.2` / `pool.lin2`, 1x1
Conv1d's, and `prior_mean` / `prior_logprec`, for ECAPA's XI pooling too),
`gemini_from_torch` (`stem_*` / `down{i}_*` -> `downsample_layers.{i}.0`
/ `.1`, `stage{i}_{j}` -> `stages.{i-1}.{j}`; `seg_1` permuted over
F / 16 frequency rows), `samresnet_from_torch` (under `front.`; ASP's
`att1` / `att_bn` / `att2` -> `pooling.attention.0` / `.2` / `.3`, whose
CF rows, columns and bias are permuted, as are `bottleneck`'s),
`repvgg_from_torch` (`dense_*` / `one_*` / `dil_*` / `id_bn` / `reparam`
-> `rbr_dense.*` / `rbr_1x1.*` / `rbr_dense_dilation.*` / `rbr_identity` /
`rbr_reparam`, `se/fc1` -> `se.fc_1`; `seg` permuted over F / 8 rows) and
`redimnet_from_torch` (under `backbone.stage{i}.{k}` Sequential indices;
`inputs_weights_{i}` (n, CF) -> (1, n, CF, 1), the final mix the last, and
the frozen all-ones stage-0 weight added; no permutation: both packages
order the 1-D axis f * C + c).

Self-supervised training (ssl/): `dino_head_from_jax` maps flax's DINOHead
(`mlp_i` / `bn_i` / `last_layer_v` / `last_layer_g`) to WeSpeaker's names
(`mlp.{i}` Sequential indices, `last_layer.weight_v` (out, bottleneck),
`last_layer.weight_g` (out, 1); without `last_layer_g`, g is 1);
`dino_state_from_jax` and `moco_state_from_jax` carry a JAX `DINOState` /
`MoCoState` (both parameter sets, both sets of BatchNorm statistics, the
centre or the queue and pointer, the optimizer's momentum or Adam moments)
to the port's names, and `load_converted_state` puts one into the port's
state objects.

Diarization: `silero_state_from_jax` maps the JAX package's Silero parameter
tree (`stft_basis`, `encoder_{i}/kernel|bias`, `lstm/weight_ih|...`,
`out/kernel|bias`; diar/silero.py's `vad.npz` layout) to
diar/silero.py:SileroVAD's state_dict (`stft_basis`, `encoder.{i}.weight`,
`lstm.weight_ih_l0`, ..., `out.weight`): the layouts already agree, only
the names change.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .resnet import strided_size

__all__ = ["from_jax_variables", "frontend_from_jax", "whisper_frontend_from_jax",
           "dino_head_from_jax", "dino_state_from_jax", "moco_state_from_jax",
           "load_converted_state", "silero_state_from_jax"]

# flax module names inside an ECAPA SE-Res2 block -> torch module paths
_SE_RES2 = {"conv1": "0", "res2": "1", "conv2": "2", "se": "3"}
# torch modules that are 1x1 Conv1d where flax has a Dense
_CONV1X1_DENSE = ("pool.linear1", "pool.linear2", "pooling.linear1", "pooling.linear2",
                  "pool.lin1_relu_bn.0", "pool.lin2", "pooling.attention.0",
                  "pooling.attention.3")
# XI pooling's flax modules -> torch's
_XI_POOL = {"lin1": "lin1_relu_bn.0", "bn1": "lin1_relu_bn.2", "lin2": "lin2"}


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


# flax module names inside the 2-D backbones -> torch's: the projection
# shortcut, and an AFF's layers in its `local_att` Sequential
_RENAME = {"shortcut_conv": "shortcut.0", "shortcut_bn": "shortcut.1",
           "att_conv1": "local_att.0", "att_bn1": "local_att.1", "att_conv2": "local_att.3",
           "att_bn2": "local_att.4"}
# list-style names inside a block: convs_0 -> convs.0, fuse_0 -> fuse_models.0
_INDEXED = re.compile(r"(convs|bns|fuse)_(\d+)")


def _block_name(name: str) -> str:
    m = _INDEXED.fullmatch(name)
    if m:
        return ("fuse_models" if m.group(1) == "fuse" else m.group(1)) + "." + m.group(2)
    return _RENAME.get(name, name)


def _resnet_module(path: Tuple[str, ...]) -> str:
    """flax module path -> torch module name (ResNet, Res2Net, ERes2Net)."""
    head = re.sub(r"^layer(\d+)_(\d+)$", r"layer\1.\2", path[0])  # not layer1_downsample
    return ".".join([head] + [_block_name(r) for r in path[1:]])


_CAMPPLUS_TOP = {"tdnn_conv": "xvector.tdnn.linear",
                 "tdnn_bn": "xvector.tdnn.nonlinear.batchnorm",
                 "out_bn": "xvector.out_nonlinear.batchnorm",
                 "dense_linear": "xvector.dense.linear",
                 "dense_bn": "xvector.dense.nonlinear.batchnorm"}


def _campplus_module(path: Tuple[str, ...]) -> str:
    """flax module path -> WeSpeaker's CAM++ name."""
    head, rest = path[0], list(path[1:])
    if head == "head":  # the FCM: ResNet's block names under `head.`
        return "head." + _resnet_module(tuple(rest))
    if head in _CAMPPLUS_TOP:
        return _CAMPPLUS_TOP[head]
    m = re.fullmatch(r"block(\d)_tdnnd(\d+)", head)
    if m:
        sub = {"nonlinear1_bn": "nonlinear1.batchnorm",
               "nonlinear2_bn": "nonlinear2.batchnorm"}
        return ".".join([f"xvector.block{m.group(1)}.tdnnd{m.group(2)}"]
                        + [sub.get(r, r) for r in rest])
    m = re.fullmatch(r"transit(\d)_(bn|linear)", head)
    if m:
        return f"xvector.transit{m.group(1)}." + (
            "nonlinear.batchnorm" if m.group(2) == "bn" else "linear")
    return ".".join([head] + rest)  # pool


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
    return _xi_pool_module(parts)


def _xi_pool_module(parts) -> str:
    """A module path, with XI pooling's flax names mapped to torch's."""
    parts = list(parts)
    if parts[0] == "pool" and len(parts) > 1:
        parts[1] = _XI_POOL.get(parts[1], parts[1])
    return ".".join(parts)


def _gemini_module(path: Tuple[str, ...]) -> str:
    head, rest = path[0], list(path[1:])
    m = re.fullmatch(r"(stem|down(\d))_(conv|bn)", head)
    if m:
        return f"downsample_layers.{m.group(2) or 0}.{0 if m.group(3) == 'conv' else 1}"
    m = re.fullmatch(r"stage(\d)_(\d+)", head)
    if m:
        head = f"stages.{int(m.group(1)) - 1}.{m.group(2)}"
    return ".".join([head] + rest)


_SAM_RENAME = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1",
               "att1": "attention.0", "att_bn": "attention.2", "att2": "attention.3"}


def _samresnet_module(path: Tuple[str, ...]) -> str:
    head, rest = path[0], [_SAM_RENAME.get(r, r) for r in path[1:]]
    if head in ("conv1", "bn1"):
        return f"front.{head}"
    m = re.fullmatch(r"layer(\d)_(\d+)", head)
    if m:
        head = f"front.layer{m.group(1)}.{m.group(2)}"
    return ".".join([head] + rest)


_REPVGG_RENAME = {"dense_conv": "rbr_dense.conv", "dense_bn": "rbr_dense.bn",
                  "one_conv": "rbr_1x1.conv", "one_bn": "rbr_1x1.bn",
                  "dil_conv": "rbr_dense_dilation.conv", "dil_bn": "rbr_dense_dilation.bn",
                  "id_bn": "rbr_identity", "reparam": "rbr_reparam", "fc1": "fc_1",
                  "fc2": "fc_2"}


def _repvgg_module(path: Tuple[str, ...]) -> str:
    head = re.sub(r"^stage(\d)_(\d+)$", r"stage\1.\2", path[0])
    return ".".join([head] + [_REPVGG_RENAME.get(r, r) for r in path[1:]])


_REDIM_BLOCK = {"ds_conv": "downsample.0", "ds_bn": "downsample.1"}
_REDIM_ATT = {"intermediate_dense": "feed_forward.intermediate_dense",
              "output_dense": "feed_forward.output_dense"}
_REDIM_TCB = {"red_conv": "red_dim_conv.0", "red_norm": "red_dim_conv.1",
              "exp_conv": "exp_dim_conv"}


def _redimnet_module_of(params: Dict):
    """The flax module path -> torch name map of a ReDimNet whose variables
    are `params` (a stage's Sequential indices depend on its blocks)."""
    def tcb_index(si):
        nb = sum(1 for k in params if re.fullmatch(rf"stage{si}_block\d+", k))
        return nb + 1 + (f"stage{si}_squeeze_conv" in params) + 1  # + to1d

    def module_of(path):
        head, rest = path[0], list(path[1:])
        if head in ("stem_conv", "stem_norm"):
            return f"backbone.stem.{0 if head == 'stem_conv' else 1}"
        m = re.fullmatch(r"stage(\d+)_(down|block(\d+)|squeeze_(conv|bn|pw)|tcb)", head)
        if not m:
            return ".".join(path)  # pool, seg_1, seg_bn_1, seg_2
        si, kind = int(m.group(1)), m.group(2)
        base = f"backbone.stage{si}"
        if kind == "down":
            return f"{base}.0"
        if m.group(3) is not None:  # a 2-D block
            rest = [re.sub(r"^dwconv_(\d+)$", r"dwconvs.\1", r) for r in rest]
            return ".".join([f"{base}.{int(m.group(3)) + 1}.conv_block"]
                            + [_REDIM_BLOCK.get(r, r) for r in rest])
        if m.group(4) is not None:  # the squeeze
            nb = tcb_index(si) - 3
            return f"{base}.{nb + 1}.{ {'conv': 0, 'bn': 1, 'pw': 3}[m.group(4)] }"
        att = 4 if "convnext_0" in params[head] else 1
        sub = rest[0]
        out = [f"{base}.{tcb_index(si)}"]
        if sub in _REDIM_TCB:
            out.append(_REDIM_TCB[sub])
        elif sub.startswith("convnext_"):
            out.append(f"tcm.{sub[len('convnext_'):]}")
            out += [re.sub(r"^dwconv_(\d+)$", r"dwconvs.\1", r) for r in rest[1:]]
        elif sub == "pos_enc":
            out += ["tcm.0"] + rest[1:]
        else:  # the transformer layer
            out += [f"tcm.{att}"] + [_REDIM_ATT.get(r, r) for r in rest[1:]]
        return ".".join(out)

    return module_of


def _multi_head_pool(module: str) -> str:
    """MHASTP's `head_{h}` and MQMHASTP's `query_{q}` flax scopes -> the
    port's (WeSpeaker's) `heads_att_trans.{h}` and `n_query.{q}`."""
    module = re.sub(r"(^|\.)query_(\d+)(?=\.)", r"\1n_query.\2", module)
    return re.sub(r"(^|\.)head_(\d+)(?=\.)", r"\1heads_att_trans.\2", module)


def _projection_from_jax(proj: Dict, stats: Dict) -> Dict[str, np.ndarray]:
    """A SpeakerNet's head in the port's names: a margin head's `weight`
    (D, C) or (D, C K) -> `projection.weight` transposed (SphereFace2 also
    its `bias` (1, 1)); LinearProduct's `bn` (with its running statistics)
    and `linear` -> `projection.trans.0` and `projection.trans.2`."""
    head: Dict[str, np.ndarray] = {}
    if "weight" in proj:
        head["projection.weight"] = _np(proj["weight"]).T
        if "bias" in proj:
            head["projection.bias"] = _np(proj["bias"])
    if "bn" in proj:
        bn, st = proj["bn"], stats.get("bn", {})
        head.update({"projection.trans.0.weight": _np(bn["scale"]),
                     "projection.trans.0.bias": _np(bn["bias"]),
                     "projection.trans.0.running_mean": _np(st["mean"]),
                     "projection.trans.0.running_var": _np(st["var"]),
                     "projection.trans.0.num_batches_tracked": np.zeros((), np.int64),
                     "projection.trans.2.weight": _np(proj["linear"]["kernel"]).T,
                     "projection.trans.2.bias": _np(proj["linear"]["bias"])})
    return head


def _permute_rows(w: np.ndarray, channels: int, freq: int, axis: int) -> np.ndarray:
    """Undo the JAX flatten order along `axis` of `w` (a multiple of C F
    long): JAX's entry i goes to WeSpeaker's `_stats_permutation` index."""
    perm = _stats_permutation(channels, freq)
    n = w.shape[axis]
    if n % perm.size:
        raise ValueError(f"{n} inputs are not a multiple of {channels} channels x {freq} "
                         "frequency rows")
    full = np.concatenate([perm + j * perm.size for j in range(n // perm.size)])
    ref = np.empty_like(w)
    index = [slice(None)] * w.ndim
    index[axis] = full
    ref[tuple(index)] = w
    return ref


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


def _whisper_module(path: Tuple[str, ...]) -> str:
    """flax module path of the JAX WhisperEncoder -> OpenAI's name."""
    head, rest = path[0], list(path[1:])
    if head.startswith("block_"):
        sub = {"mlp_0": "mlp.0", "mlp_2": "mlp.2"}
        return ".".join([f"blocks.{head[len('block_'):]}"] + [sub.get(r, r) for r in rest])
    return ".".join([head] + rest)


def whisper_frontend_from_jax(params: Dict) -> Dict[str, np.ndarray]:
    """JAX WhisperEncoder params -> the port's WhisperEncoder state_dict
    (OpenAI's encoder names, `ln_post2`)."""
    sd: Dict[str, np.ndarray] = {}
    for path, leaf in _flatten(params).items():
        module, name = _whisper_module(path[:-1]), path[-1]
        if name == "kernel":
            # conv (3, in, out) -> (out, in, 3); dense (in, out) -> (out, in)
            sd[f"{module}.weight"] = leaf.transpose(2, 1, 0) if leaf.ndim == 3 else leaf.T
        elif name == "scale":
            sd[f"{module}.weight"] = leaf
        elif name == "bias":
            sd[f"{module}.bias"] = leaf
        else:
            raise KeyError(f"unexpected flax Whisper parameter {'/'.join(path)}")
    return sd


def from_jax_variables(model_name: str, variables: Dict,
                       feat_dim: int = 80) -> Dict[str, torch.Tensor]:
    """JAX `{'params', 'batch_stats'}` of a model of the JAX registry, or of
    a SpeakerNet with one, -> state_dict of the port's module of the same
    name (with the SpeakerNet's frontend under `frontend.`).  `feat_dim` is
    the model's input width, which the 2-D families' permutations need."""
    upper = model_name.upper()
    params = variables["params"]
    if upper.startswith(("ECAPA_TDNN", "XI_VEC_ECAPA")):
        module_of = _ecapa_module
    elif upper in ("XVEC", "XI_VEC_XVEC"):
        module_of = _xi_pool_module
    elif upper.startswith("GEMINI_DF_RESNET"):
        module_of = _gemini_module
    elif upper.startswith("SIMAM_RESNET"):
        module_of = _samresnet_module
    elif upper.startswith("REPVGG"):
        module_of = _repvgg_module
    elif upper.startswith("REDIMNET"):
        module_of = _redimnet_module_of(params.get("backbone", params))
    elif upper.startswith(("RESNET", "RES2NET", "ERES2NET")):
        module_of = _resnet_module
    elif upper == "CAMPPLUS":
        module_of = _campplus_module
    elif upper.startswith("WHISPER_PMFA"):
        # pooling/linear1, bn, fc: the reference names, with the BatchNorm
        # over the pooled statistics under `bn.norm`
        module_of = lambda path: ".".join(  # noqa: E731
            ("bn", "norm") + path[1:] if path[0] == "bn" else path)
    else:
        raise ValueError(f"{model_name!r}: no model of the JAX registry")
    stats = variables.get("batch_stats", {})
    frontend: Dict[str, np.ndarray] = {}
    head: Dict[str, np.ndarray] = {}
    if "backbone" in params:  # SpeakerNet
        if "frontend" in params:
            frontend = (frontend_from_jax(params["frontend"]) if "upstream" in params["frontend"]
                        else whisper_frontend_from_jax(params["frontend"]))
        head = _projection_from_jax(params.get("projection", {}), stats.get("projection", {}))
        params = params["backbone"]
        stats = stats.get("backbone", {})

    sd: Dict[str, np.ndarray] = {}
    n_mix = sum(1 for k in params if re.fullmatch(r"stage\d+_down", k))
    for path, leaf in _flatten(params).items():
        if len(path) == 1 and path[0].startswith("inputs_weights_"):  # ReDimNet's mix
            i = n_mix if path[0].endswith("final") else int(path[0].rsplit("_", 1)[1])
            sd[f"backbone.inputs_weights.{i}"] = leaf[None, :, :, None]
            continue
        module, name = _multi_head_pool(module_of(path[:-1])), path[-1]
        if name in ("prior_mean", "prior_logprec"):  # XI pooling's prior
            sd[f"{module}.{name}"] = leaf
        elif name == "kernel":
            if leaf.ndim == 4:
                w = leaf.transpose(3, 2, 1, 0)
            elif leaf.ndim == 3:
                w = leaf.transpose(2, 1, 0)
            elif (module in _CONV1X1_DENSE or module_of is _campplus_module
                  or ".heads_att_trans." in module):
                # CAM++ holds every Dense as a 1x1 Conv1d, as WeSpeaker does
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
        module, name = _multi_head_pool(module_of(path[:-1])), path[-1]
        if name not in ("mean", "var"):
            raise KeyError(f"unexpected flax batch stat {'/'.join(path)}")
        sd[f"{module}.running_{name}"] = leaf
        sd[f"{module}.num_batches_tracked"] = np.zeros((), np.int64)
    if module_of is _campplus_module:
        # the first TDNN's input channels: JAX's f * C + c -> WeSpeaker's
        # c * F + f, C the FCM's channels
        w = sd["xvector.tdnn.linear.weight"]
        channels = sd["head.conv1.weight"].shape[0]
        ref = np.empty_like(w)
        ref[:, _stats_permutation(channels, w.shape[1] // channels)] = w
        sd["xvector.tdnn.linear.weight"] = ref
    def last_channels(prefix):
        return max(v.shape[0] for k, v in sd.items()
                   if k.startswith(prefix) and k.endswith(".weight") and v.ndim == 4)

    pool = params.get("pool", {})
    if any(re.fullmatch(r"(head|query)_\d+", k) for k in pool):
        pass  # a multi-head pooling: the port flattens as JAX does, nothing to permute
    elif module_of is _resnet_module:
        # the last map's channels: the widest conv of layer4
        sd["seg_1.weight"] = _permute_rows(sd["seg_1.weight"], last_channels("layer4."),
                                           feat_dim // 8, 1)
    elif module_of is _gemini_module:
        sd["seg_1.weight"] = _permute_rows(sd["seg_1.weight"],
                                           last_channels("downsample_layers.4."),
                                           strided_size(feat_dim, 4), 1)
    elif module_of is _repvgg_module:
        sd["seg.weight"] = _permute_rows(sd["seg.weight"], last_channels("stage4."),
                                         strided_size(feat_dim, 3), 1)
    elif module_of is _samresnet_module:
        rows = (last_channels("front.layer4."), strided_size(feat_dim, 3))
        sd["bottleneck.weight"] = _permute_rows(sd["bottleneck.weight"], *rows, 1)
        sd["pooling.attention.0.weight"] = _permute_rows(sd["pooling.attention.0.weight"],
                                                         *rows, 1)
        sd["pooling.attention.3.weight"] = _permute_rows(sd["pooling.attention.3.weight"],
                                                         *rows, 0)
        sd["pooling.attention.3.bias"] = _permute_rows(sd["pooling.attention.3.bias"], *rows, 0)
    elif upper.startswith("REDIMNET"):  # the frozen stage-0 mix weight
        sd["backbone.inputs_weights.0"] = np.ones((1, 1, 1, 1), np.float32)
    sd.update({f"frontend.{k}": v for k, v in frontend.items()})
    sd.update(head)
    return _as_torch(sd)


def dino_head_from_jax(params: Dict, stats: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """flax DINOHead parameters (and, with `use_bn`, its batch_stats) ->
    ssl/dino.py:DINOHead's state_dict."""
    stats = stats or {}
    n = sum(1 for k in params if re.fullmatch(r"mlp_\d+", k))
    use_bn = any(k.startswith("bn_") for k in params)
    per = 3 if use_bn else 2  # Linear, [BatchNorm,] GELU
    sd: Dict[str, np.ndarray] = {}
    for i in range(n):
        name = "mlp" if n == 1 else f"mlp.{per * i}"
        sd[f"{name}.weight"] = _np(params[f"mlp_{i}"]["kernel"]).T
        sd[f"{name}.bias"] = _np(params[f"mlp_{i}"]["bias"])
    for k, leaves in params.items():
        m = re.fullmatch(r"bn_(\d+)", k)
        if m:
            name = f"mlp.{per * int(m.group(1)) + 1}"
            sd[f"{name}.weight"], sd[f"{name}.bias"] = _np(leaves["scale"]), _np(leaves["bias"])
            if k not in stats:  # a gradient or optimizer tree: no statistics
                continue
            sd[f"{name}.running_mean"] = _np(stats[k]["mean"])
            sd[f"{name}.running_var"] = _np(stats[k]["var"])
            sd[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)
    v = _np(params["last_layer_v"])
    sd["last_layer.weight_v"] = v.T
    g = params.get("last_layer_g")
    sd["last_layer.weight_g"] = (_np(g) if g is not None else np.ones(v.shape[1]))[:, None]
    return _as_torch(sd)


def silero_state_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """The Silero parameter tree -> diar/silero.py:SileroVAD's state_dict."""
    sd = {"stft_basis": _np(params["stft_basis"])}
    i = 0
    while f"encoder_{i}" in params:
        sd[f"encoder.{i}.weight"] = _np(params[f"encoder_{i}"]["kernel"])
        sd[f"encoder.{i}.bias"] = _np(params[f"encoder_{i}"]["bias"])
        i += 1
    for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        sd[f"lstm.{k}_l0"] = _np(params["lstm"][k])
    sd["out.weight"] = _np(params["out"]["kernel"])
    sd["out.bias"] = _np(params["out"]["bias"])
    return _as_torch(sd)


def _as_torch(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v, np.int64 if k.endswith("tracked")
                                           else np.float32).copy()) for k, v in sd.items()}


def _net_from_jax(model_name: str, params: Dict, stats: Dict, feat_dim: int,
                  head: bool) -> Dict[str, torch.Tensor]:
    """A JAX {'backbone'[, 'head']} tree (a DINONet's, or the contrastive
    trainer's _Encoder's) -> the port module's state_dict, `backbone.` and
    `head.` prefixed."""
    bb = from_jax_variables(model_name, {"params": {"backbone": params["backbone"]},
                                         "batch_stats": {"backbone": stats.get("backbone", {})}},
                            feat_dim=feat_dim)
    sd = {f"backbone.{k}": v for k, v in bb.items()}
    if head:
        sd.update({f"head.{k}": v for k, v in
                   dino_head_from_jax(params["head"], stats.get("head")).items()})
    return sd


def _optimizer_from_jax(model_name: str, opt_state, feat_dim: int, head: bool) -> Dict:
    """optax's TraceState (momentum) or ScaleByAdamState (mu, nu, count),
    alone or inside a chain's tuple -> {"momentum_buffer": sd} or
    {"exp_avg": sd, "exp_avg_sq": sd, "step": n}."""
    parts = opt_state if isinstance(opt_state, tuple) and not hasattr(opt_state, "trace") \
        and not hasattr(opt_state, "mu") else (opt_state,)
    for part in parts:
        if hasattr(part, "trace"):
            return {"momentum_buffer": _net_from_jax(model_name, part.trace, {}, feat_dim, head)}
        if hasattr(part, "mu"):
            return {"exp_avg": _net_from_jax(model_name, part.mu, {}, feat_dim, head),
                    "exp_avg_sq": _net_from_jax(model_name, part.nu, {}, feat_dim, head),
                    "step": int(np.asarray(part.count))}
    raise ValueError(f"no momentum or Adam state in {type(opt_state).__name__}")


def dino_state_from_jax(model_name: str, state, feat_dim: int = 80) -> Dict:
    """A JAX `DINOState` -> {"step", "student", "teacher" (DINONet
    state_dicts with their BatchNorm statistics), "center", "optimizer"}."""
    return {
        "step": int(np.asarray(state.step)),
        "student": _net_from_jax(model_name, state.student_params, state.batch_stats,
                                 feat_dim, True),
        "teacher": _net_from_jax(model_name, state.teacher_params, state.teacher_batch_stats,
                                 feat_dim, True),
        "center": torch.from_numpy(np.asarray(state.center, np.float32).copy()),
        "optimizer": _optimizer_from_jax(model_name, state.opt_state, feat_dim, True),
    }


def moco_state_from_jax(model_name: str, state, feat_dim: int = 80) -> Dict:
    """A JAX `MoCoState` of an encoder {'backbone': ...} -> {"step",
    "encoder_q", "encoder_k", "queue", "queue_ptr", "optimizer"}."""
    return {
        "step": int(np.asarray(state.step)),
        "encoder_q": _net_from_jax(model_name, state.params_q, state.batch_stats_q, feat_dim,
                                   False),
        "encoder_k": _net_from_jax(model_name, state.params_k, state.batch_stats_k, feat_dim,
                                   False),
        "queue": torch.from_numpy(np.asarray(state.queue, np.float32).copy()),
        "queue_ptr": int(np.asarray(state.queue_ptr)),
        "optimizer": _optimizer_from_jax(model_name, state.opt_state, feat_dim, False),
    }


def load_converted_state(state, converted: Dict) -> None:
    """Put `dino_state_from_jax` / `moco_state_from_jax`'s result into the
    port's DINOState or MoCoState (strict loads; the optimizer's state per
    trainable parameter of the student / query encoder)."""
    nets = (("student", "teacher") if hasattr(state, "student")
            else ("encoder_q", "encoder_k"))
    for name in nets:
        getattr(state, name).load_state_dict(converted[name], strict=True)
    trained = getattr(state, nets[0])
    with torch.no_grad():
        if hasattr(state, "center"):
            state.center.copy_(converted["center"])
        else:
            state.queue.copy_(converted["queue"])
            state.queue_ptr = converted["queue_ptr"]
    state.step = converted["step"]
    opt = converted["optimizer"]
    for k, p in trained.named_parameters():
        if not p.requires_grad:
            continue
        if "momentum_buffer" in opt:
            entry = {"momentum_buffer": opt["momentum_buffer"][k].to(p.device, p.dtype, copy=True)}
        else:
            entry = {"step": torch.tensor(float(opt["step"])),
                     "exp_avg": opt["exp_avg"][k].to(p.device, p.dtype, copy=True),
                     "exp_avg_sq": opt["exp_avg_sq"][k].to(p.device, p.dtype, copy=True)}
        state.optimizer.state[p] = entry
