"""The port's bf16 extraction loses no more than the JAX package's own bf16
path, at BatchNorm statistics matched to the data.

The WavLM recipe's stage-3 embeddings in bf16 are further from float32
than embeddings at seeded weights (chip_smoke.py's `phase_wavlm_recipe`
holds them at min cosine 0.9998): trained running statistics fit the
data, so the pooled-statistics BatchNorm divides by the small spread
between utterances and scales every rounding up with it.  This test makes
that regime on a WavLM-tiny frontend and a narrow ECAPA: the running
statistics are set to the batch's own (flax's train-mode update from zero
statistics, divided by flax's 1 - momentum), and both packages embed the
same 16 speech-like utterances in float32 and in bf16 from the same
variables, by `make_eval_embed`'s steps (every float32 leaf cast, the wav
cast to bf16, the frontend, CMVN, the backbone), the features kept.

Bars, float32 JAX embeddings and features as the exact reference:
- float32 port against float32 JAX: cosine >= 0.99999;
- the frontend (features after CMVN, relative L2): the port's bf16 within
  1.1 x JAX's bf16 distance (readings 0.99-1.03 x over four weight seeds);
- the embeddings (mean of 1 - cosine over the 16): the port's bf16 within
  1.25 x JAX's (readings 0.75-1.05 x over the same seeds).  Faults of a
  bf16 path fail it: LayerNorm, GroupNorm and CMVN statistics taken in
  bf16 read 1.34 x, a truncating bf16 cast of the features 1.40 x, both
  1.58 x (the frontend bar moves 1.04-1.09 x with them);
- the regime itself: JAX's bf16 mean 1 - cosine >= 2e-4 (about 3e-5 at
  the seeded, unmatched statistics).
The two bf16 paths round independently (the port against JAX is about as
far as either from float32), so the bars compare losses, not outputs."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_port_ssl import _jax_frontend_net, cosines
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.torch_port_refs import run_jax
from wespeaker_hubert_tpu.frontend import SSLEncoderConfig as JaxSSLConfig
from wespeaker_hubert_tpu.ops.feature_utils import apply_cmvn as jax_apply_cmvn
from wespeaker_hubert_tpu.train import cast_variables_bf16 as jax_cast_bf16
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables
from wespeaker_hubert_tpu_torch.ops.feature_utils import apply_cmvn
from wespeaker_hubert_tpu_torch.train.executor import cast_variables_bf16, make_eval_embed

FRONTEND_RATIO = 1.1
EMBED_RATIO = 1.25
JAX_LOSS_MIN = 2e-4


def speech_like(n, w, seed):
    """n ragged utterances of w samples: integrated noise under a slow,
    per-utterance envelope, zero-mean, zero past each length."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, w))
    env = (np.abs(np.sin(np.arange(w) / 900.0 + rng.uniform(0, 3, (n, 1))))
           * rng.uniform(0.3, 1.0, (n, 1)))
    wav = (np.cumsum(x, 1) * 0.02 + x * 0.2) * env
    wav = (wav - wav.mean(1, keepdims=True)).astype(np.float32)
    lengths = (w * rng.uniform(0.5, 1.0, n)).astype(np.int32)
    lengths[0] = w
    for i, n_ in enumerate(lengths):
        wav[i, n_:] = 0.0
    return wav, lengths


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_loss_matches_jax_at_data_matched_statistics():
    net, variables, port = _jax_frontend_net(JaxSSLConfig.tiny("wavlm"), seed=11)
    wav, lengths = speech_like(16, 4000, seed=12)
    batch = {"wav": wav, "length": lengths}

    def reference(v, batch):
        def features(v, dtype):
            f, fl = net.apply(v, batch["wav"].astype(dtype), lengths=batch["length"],
                              train=False, method=net.features)
            return jax_apply_cmvn(f, norm_mean=True, norm_var=False, lengths=fl), fl

        f32, fl = features(v, jnp.float32)
        mask = jnp.arange(f32.shape[1])[None, :] < fl[:, None]
        zero = jax.tree.map(jnp.zeros_like, v["batch_stats"])
        _, upd = net.apply({"params": v["params"], "batch_stats": zero}, f32, mask=mask,
                           train=True, method=net.embed, mutable=["batch_stats"])
        v = {"params": v["params"],
             "batch_stats": jax.tree.map(lambda s: s / 0.1, upd["batch_stats"])}
        v16 = jax_cast_bf16(v)
        f16, _ = features(v16, jnp.bfloat16)

        def embed(v, f):  # the rest of make_eval_embed, on these features
            return net.apply(v, f, mask=mask, train=False, method=net.embed).astype(jnp.float32)

        return {"variables": v, "f32": f32, "f16": f16.astype(jnp.float32),
                "e32": embed(v, f32), "e16": embed(v16, f16)}

    want = jax.device_get(run_jax(reference, variables, jax.tree.map(jnp.asarray, batch)))
    sd = from_jax_variables("ECAPA_TDNN_GLOB_c512", want["variables"])
    port.backbone.load_state_dict({k: v for k, v in sd.items() if not k.startswith("frontend.")},
                                  strict=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    p16 = cast_variables_bf16(copy.deepcopy(port))
    with torch.inference_mode():
        feats, feat_lengths = p16.features(tbatch["wav"].to(torch.bfloat16),
                                           lengths=tbatch["length"])
        feats = apply_cmvn(feats, norm_mean=True, norm_var=False, lengths=feat_lengths)
        mask = torch.arange(feats.shape[1])[None, :] < feat_lengths[:, None]
        e16 = p16.embed(feats, mask=mask).float().numpy()  # make_eval_embed's steps
    e32 = make_eval_embed(port)(tbatch).numpy()

    assert cosines(e32, want["e32"]).min() >= 0.99999
    jax_frontend = _rel_l2(want["f16"], want["f32"])
    port_frontend = _rel_l2(feats.float().numpy(), want["f32"])
    assert port_frontend <= FRONTEND_RATIO * jax_frontend, (port_frontend, jax_frontend)
    jax_loss = float(np.mean(1.0 - cosines(want["e16"], want["e32"])))
    port_loss = float(np.mean(1.0 - cosines(e16, want["e32"])))
    assert jax_loss >= JAX_LOSS_MIN, jax_loss
    assert port_loss <= EMBED_RATIO * jax_loss, (port_loss, jax_loss)
