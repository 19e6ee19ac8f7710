"""Port parity: the SSL-frontend extraction slice against the JAX package.

The K2 flash-attention plain version against the JAX package's
`_flash_mha` (the Pallas TPU kernel in interpret mode); the port's HuBERT /
WavLM encoder against the JAX encoder and against HuggingFace's; the
converters; the frontend and `make_eval_embed`; the extraction entry
point's pieces and refusals (tests/test_torch_port_extract.py holds
`bin/extract.extract` against the JAX entry point).  Inputs and weights
come from numpy seeds; weights reach the port through `from_jax_variables`.

Tolerances: K2 float32 atol/rtol 1e-5 (one float32 softmax, sums in another
order); hidden states atol 2e-4 / rtol 1e-3, 3e-4 for WavLM against HF (the
bars of tests/test_ssl_frontend.py); float32 embeddings atol 1e-4 and cosine
>= 0.99999; bf16 embeddings cosine >= 0.9999, the JAX package's bf16 bar
(bench.py).  Scale 1/8 = 1/sqrt(64) is a power of two, so the JAX path's
folding of the scale into q rounds nothing, in bf16 too.
"""

import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.torch_port_refs import run_jax
from wespeaker_hubert_tpu.data import EvalPipeline as JaxEvalPipeline
from wespeaker_hubert_tpu.data import write_wav
from wespeaker_hubert_tpu.frontend import SSLEncoder as JaxSSLEncoder
from wespeaker_hubert_tpu.frontend import SSLEncoderConfig as JaxSSLConfig
from wespeaker_hubert_tpu.frontend import SSLFrontend as JaxSSLFrontend
from wespeaker_hubert_tpu.frontend import convert_hf_state_dict as jax_convert_hf
from wespeaker_hubert_tpu.frontend.ssl_encoder import _flash_mha
from wespeaker_hubert_tpu.models.ecapa_tdnn import EcapaTdnn as JaxEcapa
from wespeaker_hubert_tpu.models.speaker_net import SpeakerNet as JaxSpeakerNet
from wespeaker_hubert_tpu.train import cast_variables_bf16 as jax_cast_bf16
from wespeaker_hubert_tpu.train import make_eval_embed as jax_make_eval_embed
from wespeaker_hubert_tpu.utils.embeddings import load_embeddings as jax_load_embeddings
from wespeaker_hubert_tpu_torch.bin.extract import extract
from wespeaker_hubert_tpu_torch.data.dataset import EvalPipeline
from wespeaker_hubert_tpu_torch.frontend import (
    SSLEncoder,
    SSLEncoderConfig,
    SSLFrontend,
    WhisperEncoder,
    convert_hf_state_dict,
    frontend_class_dict,
    load_hf_state_dict,
)
from wespeaker_hubert_tpu_torch.frontend.ssl_encoder import _relative_positions_bucket
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables, frontend_from_jax
from wespeaker_hubert_tpu_torch.models.ecapa_tdnn import EcapaTdnn
from wespeaker_hubert_tpu_torch.models.speaker_net import SpeakerNet, build_speaker_net
from wespeaker_hubert_tpu_torch.ops import flash_attention as k2
from wespeaker_hubert_tpu_torch.train.executor import cast_variables_bf16, make_eval_embed
from wespeaker_hubert_tpu_torch.utils.config import parse_config_or_kwargs
from wespeaker_hubert_tpu_torch.utils.embeddings import load_embeddings, save_embeddings

HS_TOL = dict(atol=2e-4, rtol=1e-3)


def randomize(tree, rng):
    """Numpy draws for a flax variable tree: lecun-normal kernels, norm
    scales and gates near 1, biases, BN statistics, position-bias tables
    and featurizer weights away from flax's 0 / 1 init."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        shape = np.shape(v)
        if k == "kernel":
            x = rng.normal(0.0, float(np.prod(shape[:-1])) ** -0.5, shape)
        elif k in ("scale", "var", "gru_rel_pos_const"):
            x = rng.uniform(0.5, 1.5, shape)
        elif k in ("rel_attn_embed", "featurizer_weights"):
            x = rng.normal(0.0, 0.5, shape)
        else:  # bias, mean
            x = rng.normal(0.0, 0.1, shape)
        out[k] = x.astype(np.float32)
    return out


def cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def port_config(jax_cfg, **kw):
    fields = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(SSLEncoderConfig)}
    return SSLEncoderConfig(**{**fields, **kw})


# ------------------------------------------------------------------ K2
def _qkv(seed, b=2, t=150, h=2, hd=64):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, hd)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((b, h, t, t)).astype(np.float32)
    key_len = np.array([t, t * 2 // 3], np.int32)[:b]
    return q, k, v, bias, key_len


@pytest.mark.parametrize("case", ["gated_bias_and_padding", "padding_bias", "no_bias",
                                  "whisper_h20_scale1"])
def test_flash_plain_matches_jax_flash_kernel(case):
    """T = 150 (not a multiple of the TPU kernel's 128 blocks).  JAX gets
    the padding as a -1e9 additive bias (or, with no bias, pads T through
    SegmentIds); the port masks keys by length.  Whisper's convention: 20
    heads, q and k each scaled by hd^-0.25 before the call, scale 1.0, no
    bias and no key lengths (frontend/whisper.py:93-100)."""
    q, k, v, bias, key_len = _qkv(3)
    scale = 0.125
    pad = np.where(np.arange(q.shape[1])[None, :] < key_len[:, None], 0.0, -1e9)
    pad = pad.astype(np.float32)[:, None, None, :]
    if case == "whisper_h20_scale1":
        q, k, v, _, _ = _qkv(4, b=1, h=20)
        q, k, scale = q * 64 ** -0.25, k * 64 ** -0.25, 1.0
    ab, port_bias, port_len = {
        "gated_bias_and_padding": (bias + pad, bias, key_len),
        "padding_bias": (pad, None, key_len),
        "no_bias": (None, None, None),
        "whisper_h20_scale1": (None, None, None),
    }[case]
    with pltpu.force_tpu_interpret_mode():
        want = _flash_mha(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if ab is None else jnp.asarray(ab), scale,
        )
    got = k2.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        bias=None if port_bias is None else torch.from_numpy(port_bias),
        key_len=None if port_len is None else torch.from_numpy(port_len),
        scale=scale,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _gated_inputs(seed, b=2, t=75, h=2):
    """WavLM's factored bias: an (h, T, T) table and a (B, h, T, 1) gate in
    [1, 3) (gate_a * (gate_b * const - 1) + 2 with sigmoid gates)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, 64)).astype(np.float32) for _ in range(3))
    table = rng.standard_normal((h, t, t)).astype(np.float32)
    gate = rng.uniform(1.0, 3.0, (b, h, t, 1)).astype(np.float32)
    return q, k, v, table, gate


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_factored_bias_matches_jax_flash_kernel(dtype):
    """The gated bias in factored form (table + gate) through the plain
    forward against `_flash_mha(q, k, v, ab=gate_output * position_bias[None])`
    (the Pallas TPU kernel in interpret mode).  The bf16 effective bias is
    bit for bit JAX's bf16 product.  float32 with key lengths (JAX: a -1e9
    padding added to ab): atol 1e-5; bf16 with full lengths: atol 2e-2 and
    cosine >= 0.9999 (P is rounded to bf16 at other places)."""
    q, k, v, table, gate = _gated_inputs(11)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jq, jk, jv, jtab, jgate = (jnp.asarray(x, jdt) for x in (q, k, v, table, gate))
    ab = jgate * jtab[None]
    key_len = np.array([75, 50], np.int32) if dtype == "f32" else None
    if key_len is not None:
        pad = np.where(np.arange(75)[None, :] < key_len[:, None], 0.0, -1e9).astype(np.float32)
        ab = ab + jnp.asarray(pad)[:, None, None, :]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_flash_mha(jq, jk, jv, ab, 0.125).astype(jnp.float32))
    tq, tk, tv, ttab, tgate = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
                               for x in (jq, jk, jv, jtab, jgate))
    eff = k2.effective_bias(ttab, tgate)
    np.testing.assert_array_equal(eff.float().numpy(),
                                  np.asarray((jgate * jtab[None]).astype(jnp.float32)))
    got = k2.flash_attention(tq, tk, tv, bias=ttab, bias_gate=tgate[..., 0],
                             key_len=None if key_len is None else torch.from_numpy(key_len),
                             scale=0.125).float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=0.0)
        assert cosines(got.reshape(1, -1), want.reshape(1, -1)).min() >= 0.9999


def test_flash_tma_bias_layout():
    """The bf16 kernels read the bias by TMA: a view with a unit key stride
    and 16-byte strides passes as it is; a broadcast query axis or an odd
    row stride becomes a padded copy of the same values."""
    rng = np.random.default_rng(12)
    table = torch.from_numpy(rng.standard_normal((2, 75, 80)).astype(np.float32)).bfloat16()
    view = table[..., :75].expand(3, 2, 75, 75)
    before = k2.BIAS_RELAYOUTS
    assert k2._tma_bias(view) is view and k2.BIAS_RELAYOUTS == before
    for bias in (torch.from_numpy(rng.standard_normal((3, 1, 1, 75)).astype(np.float32)).bfloat16(),
                 table[..., :75].contiguous()):
        full = bias.expand(3, 2, 75, 75)
        laid = k2._tma_bias(full)
        assert laid.stride(3) == 1 and laid.stride(2) % 8 == 0 and laid.data_ptr() % 16 == 0
        assert torch.equal(laid, full)
    assert k2.BIAS_RELAYOUTS == before + 2
    q, kk, v, _, gate = (torch.from_numpy(x) for x in _gated_inputs(13, t=20))
    tab = torch.zeros(2, 20, 20)
    with pytest.raises(ValueError, match="bias_gate"):
        k2.kernel_strides(q, kk, v, tab, bias_gate=gate[:, :1])
    with pytest.raises(ValueError, match="table"):
        k2.kernel_strides(q, kk, v, None, bias_gate=gate)
    with pytest.raises(TypeError, match="bias_gate"):
        k2.kernel_strides(q, kk, v, tab, bias_gate=gate.double())
    assert k2.key_tile(75) == 80 and k2.key_tile(81) == 64 and k2.key_tile(499) == 64


def test_wavlm_flash_passes_the_table_padded():
    """Layer 0 builds the (h, T, T) table once with rows padded to 16 bytes
    (TMA's stride rule) and hands the same table to every layer."""
    import dataclasses

    cfg = dataclasses.replace(SSLEncoderConfig.tiny("wavlm"), attn_impl="flash")
    enc = SSLEncoder(cfg).eval()
    seen = []
    for layer in enc.encoder.layers:
        layer.attention.register_forward_hook(lambda m, a, out: seen.append(out[1]))
    with torch.no_grad():
        enc(torch.from_numpy(np.random.default_rng(0).standard_normal((1, 4000)).astype(np.float32)))
    t = seen[0].shape[-1]
    assert all(x is seen[0] for x in seen) and seen[0].stride() == (t * (t + (-t % 8)), t + (-t % 8), 1)


def test_flash_plain_broadcast_bias_and_empty_rows():
    """A (B, 1, 1, T) bias broadcasts like the materialized one; a row with
    no valid key gives 0."""
    q, k, v, _, _ = _qkv(4, t=40)
    small = np.random.default_rng(5).standard_normal((2, 1, 1, 40)).astype(np.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    a = k2.flash_attention(tq, tk, tv, bias=torch.from_numpy(small))
    b = k2.flash_attention(tq, tk, tv, bias=torch.from_numpy(np.broadcast_to(small, (2, 2, 40, 40)).copy()))
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    out = k2.flash_attention(tq, tk, tv, key_len=torch.tensor([0, 40]))
    assert float(out[0].abs().max()) == 0.0 and bool(torch.isfinite(out).all())


def _tf32(x):
    """float32 rounded to tf32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 rounds: by bit masking."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the float32 kernels form it: each operand split into tf32 hi
    and lo; the passes lo x hi, hi x lo, hi x hi, each in k8 steps (an
    exact product of tf32 values) added in order into one float32
    accumulator, as wgmma accumulates."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
        steps = torch.einsum("hqcj,hcjk->chqk", x.double().unflatten(-1, (-1, 8)),
                             y.double().unflatten(-2, (-1, 8))).float()
        for step in steps:
            acc = acc + step
    return acc


@pytest.mark.parametrize("part", ["forward", "dkv", "dq"])
def test_flash_f32_tf32x3_split_error(part):
    """The float32 K2 kernels' arithmetic (3xTF32, csrc/flash_sm90.cuh)
    emulated on softmax(q k^T) v and its dK, dV at max |S| = 40 (scale 1.0,
    Whisper's convention), where the split's relative error of about 2^-21
    per product is largest in absolute terms: within the kernels' bar, atol
    1e-4, of float64 (softmax and D in float32, as the kernels take them).
    The backward kernels form S in the forward's passes, so P = exp(S - lse)
    is formed from the scores lse was."""
    rng = np.random.default_rng(21)
    q, k, v, do = (rng.standard_normal((2, 96, 64)) for _ in range(4))  # (h, T, 64)
    s64 = q @ k.transpose(0, 2, 1)
    q, k = q * (40.0 / np.abs(s64).max()) ** 0.5, k * (40.0 / np.abs(s64).max()) ** 0.5
    q32, k32, v32, do32 = (torch.from_numpy(x.astype(np.float32)) for x in (q, k, v, do))
    q, k, v, do = (torch.from_numpy(x.astype(np.float32)).double() for x in (q, k, v, do))
    s = _mm_3xtf32(q32, k32.transpose(1, 2))
    assert abs(float(s.abs().max()) - 40.0) < 1e-3
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.exp(s - lse)
    p64 = torch.softmax(q @ k.transpose(1, 2), -1)
    out = _mm_3xtf32(p, v32)
    out64 = p64 @ v
    if part == "forward":
        torch.testing.assert_close(out.double(), out64, atol=1e-4, rtol=0.0)
        return
    delta = (out * do32).sum(-1, keepdim=True)
    ds = p * (_mm_3xtf32(do32, v32.transpose(1, 2)) - delta)
    ds64 = p64 * (do @ v.transpose(1, 2) - (out64 * do).sum(-1, keepdim=True))
    if part == "dq":
        torch.testing.assert_close(_mm_3xtf32(ds, k32).double(), ds64 @ k, atol=1e-4, rtol=0.0)
        return
    dv, dk = _mm_3xtf32(p.transpose(1, 2), do32), _mm_3xtf32(ds.transpose(1, 2), q32)
    torch.testing.assert_close(dv.double(), p64.transpose(1, 2) @ do, atol=1e-4, rtol=0.0)
    torch.testing.assert_close(dk.double(), ds64.transpose(1, 2) @ q, atol=1e-4, rtol=0.0)


def test_flash_kernel_checks_refuse():
    q, k, v, bias, key_len = (torch.from_numpy(x) for x in _qkv(6, t=20))
    bias16 = bias.to(torch.bfloat16)
    k2.kernel_strides(q, k, v, bias, key_len)  # what the kernel takes
    with pytest.raises(ValueError, match="head dim 64"):
        k2.kernel_strides(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(TypeError):
        k2.kernel_strides(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="bias"):
        k2.kernel_strides(q, k, v, bias16)
    with pytest.raises(ValueError, match="contiguous head dim"):
        qt = q.transpose(2, 3).contiguous().transpose(2, 3)
        k2.kernel_strides(qt, k, v)
    with pytest.raises(ValueError, match="key_len"):
        k2.kernel_strides(q, k, v, key_len=key_len[:1])
    with pytest.raises(ValueError, match="one shape"):
        k2.kernel_strides(q, k[:, :10], v)
    strides = k2.kernel_strides(q, k, v, bias[:, :1, :1])[1]
    assert strides[9:] == (800, 0, 0, 1)  # a (B, 1, 1, T) slice broadcast


# ------------------------------------------------------------------ encoder
VARIANTS = {
    "hubert_post_ln": ("hubert", False),
    "hubert_stable_ln": ("hubert", True),
    "wavlm_post_ln": ("wavlm", False),
    "wavlm_stable_ln": ("wavlm", True),
}


def _variant_cfg(name):
    model_type, stable = VARIANTS[name]
    cfg = JaxSSLConfig.tiny(model_type, stable)
    if stable:  # the large models' layer-norm conv extractor
        cfg = dataclasses.replace(cfg, feat_extract_norm="layer")
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_encoder_run(name):
    cfg = _variant_cfg(name)
    rng = np.random.default_rng(sorted(VARIANTS).index(name))
    wav = (rng.standard_normal((3, 3200)) * 0.5).astype(np.float32)
    lengths = np.array([3200, 2000, 1100], np.int32)
    model = JaxSSLEncoder(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), wav, lengths))
    params = randomize(shapes["params"], rng)
    hidden, feat_lengths = run_jax(lambda p, w, n: model.apply({"params": p}, w, n),
                                   params, wav, lengths)
    return cfg, params, wav, lengths, [np.asarray(h) for h in hidden], np.asarray(feat_lengths)


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_encoder_matches_jax(variant, attn_impl):
    cfg, params, wav, lengths, want, want_len = _jax_encoder_run(variant)
    enc = SSLEncoder(port_config(cfg, attn_impl=attn_impl)).eval()
    sd = frontend_from_jax({"upstream": params})
    enc.load_state_dict(
        {k[len("upstream."):]: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()},
        strict=True,
    )
    with torch.no_grad():
        got, got_len = enc(torch.from_numpy(wav), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_len.numpy(), want_len)
    assert len(got) == len(want) == cfg.num_hidden_layers + 1
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, **HS_TOL, err_msg=f"hidden state {i}")


def _hf_model(variant):
    from transformers import HubertConfig, HubertModel, WavLMConfig, WavLMModel

    cfg = _variant_cfg(variant)
    kwargs = dict(
        hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size,
        conv_dim=list(cfg.conv_dim),
        conv_kernel=list(cfg.conv_kernel),
        conv_stride=list(cfg.conv_stride),
        feat_extract_norm=cfg.feat_extract_norm,
        do_stable_layer_norm=cfg.do_stable_layer_norm,
        num_conv_pos_embeddings=cfg.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=cfg.num_conv_pos_embedding_groups,
        hidden_dropout=0.0,
        activation_dropout=0.0,
        attention_dropout=0.0,
        feat_proj_dropout=0.0,
        layerdrop=0.0,
        apply_spec_augment=False,
    )
    torch.manual_seed(sorted(VARIANTS).index(variant))
    if cfg.model_type == "wavlm":
        kwargs.update(num_buckets=cfg.num_buckets, max_bucket_distance=cfg.max_distance)
        return cfg, WavLMModel(WavLMConfig(**kwargs)).eval()
    return cfg, HubertModel(HubertConfig(**kwargs)).eval()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_encoder_loads_hf_model(variant):
    """A random-init transformers model (weight-norm positional conv) loads
    into the port's encoder as it is; every hidden state agrees."""
    cfg, hf = _hf_model(variant)
    assert any("pos_conv_embed.conv" in k and ("weight_g" in k or "original0" in k)
               for k in hf.state_dict())
    wav = torch.from_numpy(
        np.random.default_rng(7).standard_normal((2, 3200)).astype(np.float32)
    )
    with torch.no_grad():
        want = hf(wav, output_hidden_states=True).hidden_states
        enc = SSLEncoder(port_config(cfg, attn_impl="flash")).eval()
        load_hf_state_dict(enc, hf.state_dict())
        got, _ = enc(wav)
    atol = 3e-4 if cfg.model_type == "wavlm" else 2e-4
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=atol, rtol=1e-3,
                                   err_msg=f"hidden state {i}")


@pytest.mark.parametrize("variant", ["hubert_post_ln", "wavlm_stable_ln"])
def test_converter_round_trip(variant):
    """HF state_dict -> JAX convert_hf_state_dict -> port frontend_from_jax
    gives the port's HF loader's state_dict key for key, which is HF's own
    apart from the composed positional conv and the pretraining-only
    masked_spec_embed."""
    cfg, hf = _hf_model(variant)
    hf_sd = hf.state_dict()
    via_jax = frontend_from_jax({"upstream": jax_convert_hf(hf_sd, cfg)})
    direct = convert_hf_state_dict(hf_sd)
    assert sorted(via_jax) == sorted("upstream." + k for k in direct)
    for k, v in direct.items():
        np.testing.assert_allclose(np.asarray(via_jax["upstream." + k]), v.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        if k in hf_sd:
            assert torch.equal(v, hf_sd[k]), k
    skipped = set(hf_sd) - set(direct)
    assert skipped and all("masked_spec_embed" in k or "pos_conv_embed.conv" in k
                           for k in skipped)


def test_relative_position_buckets_are_the_jax_table():
    from wespeaker_hubert_tpu.frontend.ssl_encoder import (
        _relative_positions_bucket as jax_buckets,
    )

    pos = np.arange(499)
    rel = pos[None, :] - pos[:, None]
    np.testing.assert_array_equal(
        _relative_positions_bucket(rel, 320, 800), jax_buckets(rel, 320, 800)
    )


# --------------------------------------------------- frontend and eval embed
def _jax_frontend_net(cfg, channels=32, embed_dim=16, layer=-1, multilayer=True, seed=0):
    """A JAX SpeakerNet with an SSL frontend and a narrow ECAPA (as
    bench_all.py builds it), random variables, its port counterpart."""
    frontend = JaxSSLFrontend(cfg, frozen=True, layer=layer, multilayer_feature=multilayer)
    backbone = JaxEcapa(channels, cfg.hidden_size, embed_dim, "ASTP", True, False)
    net = JaxSpeakerNet(backbone=backbone, projection=None, frontend=frontend)
    wav = jnp.zeros((1, 3200))
    fshapes = jax.eval_shape(lambda: net.init(jax.random.key(0), wav, train=False,
                                              method=net.features))
    bshapes = jax.eval_shape(lambda: backbone.init(
        jax.random.key(1), jnp.zeros((1, 50, cfg.hidden_size)), train=False))
    rng = np.random.default_rng(seed)
    variables = {
        "params": {**randomize(fshapes["params"], rng),
                   "backbone": randomize(bshapes["params"], rng)},
        "batch_stats": {"backbone": randomize(bshapes["batch_stats"], rng)},
    }
    port = SpeakerNet(
        EcapaTdnn(channels, cfg.hidden_size, embed_dim, "ASTP", True),
        SSLFrontend(port_config(cfg, attn_impl="flash"), layer=layer,
                    multilayer_feature=multilayer),
    ).eval()
    sd = from_jax_variables("ECAPA_TDNN_GLOB_c512", variables)
    missing, unexpected = port.backbone.load_state_dict(
        {k: v for k, v in sd.items() if not k.startswith("frontend.")}, strict=True)
    port.frontend.load_state_dict(
        {k[len("frontend."):]: v for k, v in sd.items() if k.startswith("frontend.")},
        strict=True)
    return net, variables, port


def _wav_batch(seed, n=3, w=4800):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((n, w)) * 0.3).astype(np.float32)
    lengths = np.array([w, w * 2 // 3, w // 3][:n], np.int32)
    for i, n_ in enumerate(lengths):
        wav[i, n_:] = 0.0
    return wav, lengths


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wavlm_eval_embed_matches_jax(dtype):
    """make_eval_embed through a WavLM-tiny frontend and ECAPA, with
    lengths (masking, CMVN lengths, pooling masks)."""
    cfg = JaxSSLConfig.tiny("wavlm")
    net, variables, port = _jax_frontend_net(cfg, seed=11)
    wav, lengths = _wav_batch(12)
    batch = {"wav": wav, "length": lengths}
    if dtype == "bf16":
        want = jax_make_eval_embed(net, compute_dtype=jnp.bfloat16)(
            jax_cast_bf16(variables), batch)
        got = make_eval_embed(cast_variables_bf16(port), compute_dtype=torch.bfloat16)(
            {k: torch.from_numpy(v) for k, v in batch.items()})
        assert got.dtype == torch.float32
        assert cosines(got.numpy(), np.asarray(want)).min() >= 0.9999
    else:
        want = jax_make_eval_embed(net)(variables, batch)
        got = make_eval_embed(port)({k: torch.from_numpy(v) for k, v in batch.items()})
        assert cosines(got.numpy(), np.asarray(want)).min() >= 0.99999
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("layer,multilayer", [(1, True), (-1, False)])
def test_frontend_layer_selection_matches_jax(layer, multilayer):
    cfg = JaxSSLConfig.tiny("hubert")
    net, variables, port = _jax_frontend_net(cfg, layer=layer, multilayer=multilayer, seed=13)
    wav, lengths = _wav_batch(14)
    want, want_len = run_jax(lambda v, w, n: net.apply(v, w, n, method=net.features),
                             variables, wav, lengths)
    with torch.no_grad():
        got, got_len = port.features(torch.from_numpy(wav), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HS_TOL)
    assert (port.frontend.featurizer_weights is None) == (layer >= 0)
    with pytest.raises(ValueError, match="out of range"):
        SSLFrontend(port_config(cfg), layer=cfg.num_hidden_layers + 1)


# ------------------------------------------------------------- the slice
SR = 16000
# two extraction buckets: up to 2 s (32,240 samples) and up to 4 s
SECONDS = (0.7, 1.3, 1.9, 2.2, 2.9, 3.6)


def slice_config(compute_dtype=None):
    cfg = {
        "model": "ECAPA_TDNN_GLOB_c512",
        "model_args": {"embed_dim": 16, "pooling_func": "ASTP"},
        "dataset_args": {
            "resample_rate": SR,
            "frontend": "s3prl",
            "s3prl_args": {"upstream": "tiny", "attn_impl": "flash", "frozen": True},
        },
    }
    if compute_dtype:
        cfg["compute_dtype"] = compute_dtype
    return cfg


def write_slice_list(root):
    """Six seeded wavs over two buckets and their raw JSONL list."""
    rng = np.random.default_rng(21)
    lines = []
    for i, sec in enumerate(SECONDS):
        x = np.clip(rng.standard_normal(int(sec * SR)) * 0.2, -1, 1)
        path = root / f"u{i}.wav"
        write_wav(str(path), x, SR)
        lines.append(json.dumps({"key": f"utt{i}", "wav": str(path)}))
    (root / "wav.jsonl").write_text("\n".join(lines) + "\n")
    return root / "wav.jsonl"


@pytest.fixture(scope="module")
def port_slice(tmp_path_factory):
    """The slice's wav list and a .pt in the port's names."""
    root = tmp_path_factory.mktemp("port_slice")
    write_slice_list(root)
    torch.manual_seed(0)
    net = build_speaker_net(slice_config())
    torch.save({**net.backbone.state_dict(),
                **{"frontend." + k: v for k, v in net.frontend.state_dict().items()}},
               root / "model.pt")
    return root


def test_extract_refusals(port_slice, tmp_path):
    root = port_slice
    lst, ckpt = str(root / "wav.jsonl"), str(root / "model.pt")
    config = slice_config()
    if not torch.cuda.is_available():  # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA requested"):
            extract(config, lst, ckpt, "")
    with pytest.raises(ValueError, match="data_type=feat"):
        extract(config, lst, ckpt, "", data_type="feat", device="cpu")
    frontend_only = {k: v for k, v in torch.load(ckpt).items() if k.startswith("frontend.")}
    torch.save(frontend_only, tmp_path / "frontend_only.pt")
    with pytest.raises(RuntimeError, match="matched no backbone"):
        extract(config, lst, str(tmp_path / "frontend_only.pt"), "", device="cpu")
    (tmp_path / "bad.jsonl").write_text(json.dumps({"key": "x", "wav": "/nonexistent.wav"}) + "\n")
    with pytest.raises(RuntimeError, match="0 embeddings"):
        extract(config, str(tmp_path / "bad.jsonl"), ckpt, "", device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        build_speaker_net({"model": "ECAPA_TDNN_c512",
                           "dataset_args": {"frontend": "whisper_encoder",
                                            "whisper_encoder_args": {"pipeline_parallel": 4}}})
    assert frontend_class_dict["whisper_encoder"] is WhisperEncoder
    assert list(EvalPipeline([], data_type="shard")) == []  # tar shards are read


def test_config_json_and_yaml(tmp_path, monkeypatch):
    cfg = slice_config()
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    assert parse_config_or_kwargs(str(tmp_path / "c.json"), compute_dtype="bf16") == {
        **cfg, "compute_dtype": "bf16"}
    assert parse_config_or_kwargs(cfg) == cfg
    yaml = pytest.importorskip("yaml")
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(cfg))
    assert parse_config_or_kwargs(str(tmp_path / "c.yaml")) == cfg
    monkeypatch.setitem(sys.modules, "yaml", None)  # PyYAML absent: the port's own reader
    assert parse_config_or_kwargs(str(tmp_path / "c.yaml")) == cfg


@pytest.mark.parametrize("data_type", ["raw", "feat"])
def test_eval_pipeline_matches_jax(port_slice, tmp_path, data_type):
    from wespeaker_hubert_tpu.backend.kaldi_io import write_kaldi_matrices

    if data_type == "raw":
        entries = (port_slice / "wav.jsonl").read_text().splitlines()
    else:
        rng = np.random.default_rng(31)
        mats = [rng.standard_normal((n, 8)).astype(np.float32) for n in (150, 260, 90, 900)]
        names = [f"f{i}" for i in range(len(mats))]
        write_kaldi_matrices(str(tmp_path / "f.ark"), names, mats, str(tmp_path / "f.scp"))
        entries = [json.dumps({"key": k, "feat": spec.split(" ", 1)[1]})
                   for k, spec in zip(names, (tmp_path / "f.scp").read_text().split("\n"))]
    got = list(EvalPipeline(entries, data_type=data_type, batch_size=2))
    want = list(JaxEvalPipeline(entries, data_type=data_type, batch_size=2))
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


def test_embeddings_round_trip(tmp_path):
    keys = ["a", "b", "c"]
    emb = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    save_embeddings(str(tmp_path / "e.npz"), keys, emb)
    for load in (load_embeddings, jax_load_embeddings):
        k, e = load(str(tmp_path / "e.npz"))
        assert k == keys and np.array_equal(e, emb)
    with pytest.raises(ValueError):
        save_embeddings(str(tmp_path / "x.npz"), keys, emb[:2])
