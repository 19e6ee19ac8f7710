"""Port parity: fbank frontend (plain PyTorch path and the fused fbank
kernel's plain version) against the JAX package's fbank, its Pallas kernel
in interpret mode and the scalar Kaldi loop; CMVN against JAX.

Tolerances: log-mel rtol 1e-4 / atol 2e-3, the JAX package's own bar for
its Pallas kernel (tests/test_fbank_pallas.py), since the folded
effective-matrix algebra rounds differently from the step-by-step path;
CMVN 1e-5 (float32 sums in another order).  The kernel itself runs only
on a GPU (tests/test_torch_port_gpu.py); its host tables are checked here:
the sparse mel filters against `mel_banks` exactly, and a numpy model of
its FFT schedule against np.fft.rfft (1e-5 of the largest bin)."""

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
from wespeaker_hubert_tpu_torch.ops.signal import mel_banks, window_function

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


@pytest.mark.parametrize(
    "kw", [{}, {"num_mel_bins": 72}, {"num_mel_bins": 40}, {"sample_rate": 8000},
           {"sample_rate": 48000, "low_freq": 0.0, "high_freq": -400.0}],
)
def test_mel_csr_reproduces_mel_banks(kw):
    """The kernel's sparse filters, densified, are `mel_banks` bit for bit."""
    cfg = FbankConfig(**kw)
    tab, weights = port_kernel.mel_csr(cfg)
    want = mel_banks(cfg.num_mel_bins, cfg.fft_size, float(cfg.sample_rate), cfg.low_freq,
                     cfg.high_freq)
    dense = np.zeros_like(want)
    for m, (first, count, offset) in enumerate(tab.T):
        dense[first:first + count, m] = weights[offset:offset + count]
    assert weights.dtype == np.float32 and tab.dtype == np.int32
    assert np.array_equal(dense, want)


def _kernel_spectrum(xd, cfg):
    """A numpy model of the kernel's transform (csrc/fbank.cu) of one
    DC-removed frame x' (L float32 samples), with its tables, in complex64:
    u = window x' and the pre-emphasis correction d, scaled by s =
    `correction_scale` (folded into the dwindow table), into z = u + i s d;
    the Stockham stages of `FFT_RADICES[n]`, butterfly j twiddling point r
    by table entry r (j mod ns) n / (ns R) and writing it at (j - j mod ns)
    R + j mod ns + r ns; then U, s D split from Z[k], Z[n - k] and Y[k] =
    emph[k] U[k] - (c / s) s D[k]."""
    tw, emph, win, dwin, _, _ = (t.numpy() for t in port_kernel.kernel_tables(cfg, "cpu"))
    c64 = lambda t: (t[:, 0] + 1j * t[:, 1]).astype(np.complex64)  # noqa: E731
    w, n, L, c = c64(tw), cfg.fft_size, len(xd), np.float32(cfg.preemph_coeff)
    s = np.float32(port_kernel.correction_scale(win))
    u = np.zeros(n, np.float32)
    d = np.zeros(n, np.float32)
    u[:L] = win * xd
    d[1:L] = dwin[1:] * xd[:-1]
    d[0] += dwin[0] * xd[0]
    d[L % n] -= s * u[L - 1]
    data = (u + 1j * d).astype(np.complex64)
    ns = 1
    for r_ in port_kernel.FFT_RADICES[n]:
        nb = n // r_
        j = np.arange(nb)
        k = j % ns
        v = np.stack([data[j + r * nb] * w[r * k * (n // (ns * r_))] for r in range(r_)])
        dft = np.exp(-2j * np.pi * np.outer(np.arange(r_), np.arange(r_)) / r_)
        v = (dft @ v).astype(np.complex64)
        out = np.empty_like(data)
        for r in range(r_):
            out[(j - k) * r_ + k + r * ns] = v[r]
        data, ns = out, ns * r_
    assert ns == n
    kk = np.arange(n // 2 + 1)
    a, bc = data[kk], np.conj(data[(n - kk) % n])
    return c64(emph) * ((a + bc) * 0.5) - (c / s) * ((a - bc) * -0.5j)


@pytest.mark.parametrize("kw", [{"sample_rate": 8000}, {}, {"frame_length_ms": 32.0}],
                         ids=["n256", "n512", "frame_is_n512"])
def test_fft_schedule_matches_rfft(kw):
    """The kernel's transform, driven by its tables, is the real FFT of the
    pre-emphasized windowed frame: a wrong twiddle index or correction term
    shows here (1e-5 of the largest bin)."""
    cfg = FbankConfig(**kw)
    xd = _wav(cfg.fft_size, (cfg.frame_length,)) * np.float32(32768.0)
    got = _kernel_spectrum(xd, cfg)
    x = xd.astype(np.float64)
    y = window_function(cfg.window_type, len(x)).astype(np.float32) * (
        x - cfg.preemph_coeff * np.concatenate([x[:1], x[:-1]]))
    want = np.fft.rfft(y, cfg.fft_size)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


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
