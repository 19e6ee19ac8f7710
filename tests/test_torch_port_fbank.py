"""Port parity: fbank frontend (plain PyTorch path and the fused fbank
kernel's plain version) against the JAX package's fbank, its Pallas kernel
in interpret mode and the scalar Kaldi loop; CMVN against JAX.

Tolerances: log-mel rtol 1e-4 / atol 2e-3, the JAX package's own bar for
its Pallas kernel (tests/test_fbank_pallas.py), since the folded
effective-matrix algebra rounds differently from the step-by-step path;
CMVN 1e-5 (float32 sums in another order).  The kernel itself runs only
on a GPU: tests/test_torch_port_gpu.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden_fbank import golden_fbank
from wespeaker_hubert_tpu.ops import fbank_pallas as jax_fbank_pallas
from wespeaker_hubert_tpu.ops.fbank import FbankConfig as JaxFbankConfig
from wespeaker_hubert_tpu.ops.fbank import fbank as jax_fbank
from wespeaker_hubert_tpu.ops.feature_utils import apply_cmvn as jax_apply_cmvn
from wespeaker_hubert_tpu_torch.ops import fbank_kernel as port_kernel
from wespeaker_hubert_tpu_torch.ops.fbank import FbankConfig, fbank
from wespeaker_hubert_tpu_torch.ops.feature_utils import apply_cmvn

FBANK_TOL = dict(rtol=1e-4, atol=2e-3)


def _wav(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.1).clip(-1, 1).astype(np.float32)


@pytest.mark.parametrize("samples,mels", [(16000, 80), (32240, 80), (16000, 40), (32240, 40)])
def test_plain_and_kernel_reference_match_jax(samples, mels):
    wav = _wav(samples + mels, (2, samples))
    jcfg = JaxFbankConfig(dither=0.0, num_mel_bins=mels)
    want_matmul, _ = jax_fbank(jnp.asarray(wav), jcfg)
    want_pallas = jax_fbank_pallas.fbank_pallas(jnp.asarray(wav), jcfg, interpret=True)

    cfg = FbankConfig(dither=0.0, num_mel_bins=mels)
    got_plain, _ = fbank(torch.from_numpy(wav), cfg)
    got_ref = port_kernel.fbank_kernel_reference(torch.from_numpy(wav), cfg)
    t = 1 + (samples - 400) // 160
    for got in (got_plain, got_ref):
        assert tuple(got.shape) == (2, t, mels)
        for want in (want_matmul, want_pallas):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **FBANK_TOL)


@pytest.mark.parametrize("impl", ["matmul", "fft", "kernel"])
def test_matches_golden_scalar_loop(impl):
    wav = _wav(3, (1, 16000))
    want = golden_fbank(wav[0])
    cfg = FbankConfig(spectrum_impl=impl)
    got, _ = fbank(torch.from_numpy(wav), cfg)
    np.testing.assert_allclose(got[0].numpy(), want, **FBANK_TOL)
    ref = port_kernel.fbank_kernel_reference(torch.from_numpy(wav), cfg)
    np.testing.assert_allclose(ref[0].numpy(), want, **FBANK_TOL)


@pytest.mark.parametrize(
    "kw",
    [{}, {"num_mel_bins": 40}, {"window_type": "povey", "scale_to_int16": False},
     {"sample_rate": 8000, "preemph_coeff": 0.0, "remove_dc_offset": False}],
)
def test_effective_matrices_bit_identical(kw):
    want = jax_fbank_pallas._effective_matrices(JaxFbankConfig(**kw))
    got = port_kernel._effective_matrices(FbankConfig(**kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_feat_lengths_match_jax():
    wav = _wav(4, (4, 16000))
    lengths = np.array([16000, 399, 400, 9000], np.int32)
    _, want = jax_fbank(jnp.asarray(wav), JaxFbankConfig(), lengths=jnp.asarray(lengths))
    _, got = fbank(torch.from_numpy(wav), FbankConfig(), lengths=torch.from_numpy(lengths))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("norm_var", [False, True])
@pytest.mark.parametrize("norm_mean", [False, True])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_apply_cmvn_matches_jax(with_lengths, norm_mean, norm_var):
    x = np.random.default_rng(5).standard_normal((3, 50, 8)).astype(np.float32) + 2.0
    lengths = np.array([50, 17, 1], np.int32) if with_lengths else None
    want = jax_apply_cmvn(
        jnp.asarray(x), norm_mean, norm_var,
        None if lengths is None else jnp.asarray(lengths),
    )
    got = apply_cmvn(
        torch.from_numpy(x), norm_mean, norm_var,
        None if lengths is None else torch.from_numpy(lengths),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_kernel_rejects_dither():
    with pytest.raises(ValueError, match="dither"):
        port_kernel.fbank_kernel(torch.zeros(1, 16000), FbankConfig(dither=1.0))


@pytest.mark.parametrize(
    "kw,match", [({"use_log": False}, "log"), ({}, "CUDA tensor")]
)
def test_kernel_rejects_what_it_does_not_compute(kw, match):
    # the wrapper launches its kernel or raises: no CPU route, no linear mel
    with pytest.raises(ValueError, match=match):
        port_kernel.fbank_kernel(torch.zeros(1, 16000), FbankConfig(**kw))


@pytest.mark.parametrize(
    "impl,kw", [("pallas", {}), ("kernel", {}), ("kernel", {"use_log": False})]
)
def test_kernel_setting_on_cpu_gives_plain_result(impl, kw):
    wav = torch.from_numpy(_wav(6, (2, 16000)))
    launches = port_kernel.LAUNCHES
    want, _ = fbank(wav, FbankConfig(**kw))
    got, _ = fbank(wav, FbankConfig(spectrum_impl=impl, **kw))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert port_kernel.LAUNCHES == launches


def test_dither_uses_generator():
    wav = torch.from_numpy(_wav(7, (1, 16000)))
    cfg = FbankConfig(dither=1.0)
    a, _ = fbank(wav, cfg, generator=torch.Generator().manual_seed(0))
    b, _ = fbank(wav, cfg, generator=torch.Generator().manual_seed(0))
    c, _ = fbank(wav, cfg)  # no generator: eval, no dither
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(c, fbank(wav, dataclasses.replace(cfg, dither=0.0))[0])
    assert not torch.equal(a, c)
