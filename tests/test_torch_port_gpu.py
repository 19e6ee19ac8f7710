"""The port's CUDA kernels and served path on a GPU (`cuda` marker; they
skip without one).  This file imports no JAX, and tests/conftest.py does,
so on a machine without JAX run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py

K1 against its plain version: rtol 1e-4 / atol 2e-3, the bar of the JAX
package's Pallas fbank; against the plain rFFT path at that bar wherever the
path meets it against the plain version (its float32 pre-emphasized frames
can miss it at a rare low-energy filter).  K2 (flash attention) against its plain version:
float32 atol 1e-4 (float32 sums in another order); bf16 against the plain
bf16 path compared in float32, atol 2e-2 and cosine >= 0.9999 (the kernel
rounds the unnormalized probabilities to bf16 before P V, the plain version
the normalized ones).  K2's backward (dq, dk, dv, dbias) against its plain
version: float32 atol 1e-4; bf16 cosine >= 0.9999 per gradient (the kernels
round P and dS to bf16 as the A operand of their products), and so are the
gate's gradient and D, which the dQ kernel forms.  The float32 forward and
dK/dV run 3xTF32 on wgmma; at logits scaled to max |S| = 40 a gradient that
misses atol 1e-4 against the plain version, which is itself 1e-4 or more
from float64 there, is held to float64 (LARGE_LOGIT_RATIO).  WavLM's gated bias in
factored form (an (h, T, T) table, a (B, h, T) gate) at the bars above, T in
{75, 99, 131, 499, 1599}.  Float32 embeddings cosine >= 0.99999
against the CPU (TF32 off)."""

import json

import numpy as np
import pytest
import torch

from wespeaker_hubert_tpu_torch.ops import fbank_kernel
from wespeaker_hubert_tpu_torch.ops import flash_attention as k2
from wespeaker_hubert_tpu_torch.ops.fbank import FbankConfig, fbank

FBANK_TOL = dict(rtol=1e-4, atol=2e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _wav(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,kw",
    [((4, 32000), {}), ((1, 32240), {"num_mel_bins": 40}), ((3, 401), {}),
     ((2, 16000), {"sample_rate": 8000}), ((3, 24000), {"num_mel_bins": 72}),
     ((32, 64240), {"num_mel_bins": 72}),
     ((2, 48000), {"sample_rate": 48000, "window_type": "povey", "preemph_coeff": 0.0}),
     ((2, 22050), {"sample_rate": 22050, "remove_dc_offset": False, "scale_to_int16": False})],
)
def test_fbank_kernel_matches_plain(cuda, shape, kw):
    cfg = FbankConfig(spectrum_impl="kernel", **kw)
    wav = _wav(sum(shape), shape).to(cuda)
    launches = fbank_kernel.LAUNCHES
    got = fbank_kernel.fbank_kernel(wav, cfg)
    torch.cuda.synchronize()
    assert fbank_kernel.LAUNCHES == launches + 1
    want = fbank_kernel.fbank_kernel_reference(wav, cfg)
    torch.testing.assert_close(got, want, **FBANK_TOL)
    # the plain rFFT path (cuFFT + the dense mel product), the steps the
    # kernel takes, on every element where that path meets the bar against
    # the plain version (its float32 pre-emphasized frame can miss it at a
    # rare low-energy filter: csrc/fbank.cu)
    fft, _ = fbank(wav, FbankConfig(spectrum_impl="fft", **kw))
    fft_ok = torch.isclose(fft, want, **FBANK_TOL)
    assert float(fft_ok.float().mean()) > 0.999
    assert bool((torch.isclose(got, fft, **FBANK_TOL) | ~fft_ok).all())
    # fbank() routes dither-free CUDA log-mel batches to the kernel, and the
    # step-by-step plain path agrees with it
    routed, _ = fbank(wav, cfg)
    assert fbank_kernel.LAUNCHES == launches + 2
    plain, _ = fbank(wav.cpu(), FbankConfig(**kw))
    torch.testing.assert_close(routed.cpu(), plain, **FBANK_TOL)
    # a linear mel (use_log=False) is not the kernel's: the plain path
    fbank(wav, FbankConfig(spectrum_impl="kernel", use_log=False, **kw))
    assert fbank_kernel.LAUNCHES == launches + 2


def _fbank_float64(wav, cfg):
    """Log-mel of (B, W) in float64, the plain rFFT path's steps."""
    from wespeaker_hubert_tpu_torch.ops.fbank import frame_signal
    from wespeaker_hubert_tpu_torch.ops.signal import mel_banks, window_function

    x = frame_signal(wav.double() * 32768.0, cfg.frame_length, cfg.frame_shift)
    x = x - x.mean(-1, keepdim=True)
    x = x - cfg.preemph_coeff * torch.cat([x[..., :1], x[..., :-1]], -1)
    x = x * torch.from_numpy(window_function(cfg.window_type, cfg.frame_length)).to(x)
    spec = torch.fft.rfft(x, n=cfg.fft_size)
    mel = torch.from_numpy(mel_banks(cfg.num_mel_bins, cfg.fft_size, float(cfg.sample_rate),
                                     cfg.low_freq, cfg.high_freq).astype(np.float64)).to(x)
    return torch.log(torch.clamp_min((spec.real ** 2 + spec.imag ** 2) @ mel,
                                     float(np.finfo(np.float32).eps)))


@pytest.mark.cuda
def test_fbank_kernel_quiet_low_bins(cuda):
    """Loud low harmonics over a faint noise floor leave the lowest mels
    some e^20 below the frame's loudest: the FFT's rounding, relative to
    the loud part, must not reach them through the pre-emphasis correction
    (it did while that correction shared the FFT unscaled: 3.6e-3 from
    float64).  K1 within the bar of a float64 log-mel everywhere, and of its
    plain version wherever that version meets the float64 one."""
    rng = np.random.default_rng(0)
    t = np.arange(16240) / 16000
    rows = []
    for _ in range(64):
        f0 = rng.uniform(90, 280)
        x = (0.5 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6))
             + 0.25 * np.sin(4 * np.pi * f0 * t + 1.0) + 0.001 * rng.standard_normal(len(t)))
        rows.append(np.round(np.clip(x, -1, 1) * 32767) / 32768)
    wav = torch.from_numpy(np.stack(rows).astype(np.float32)).to(cuda)
    cfg = FbankConfig(spectrum_impl="kernel")
    got = fbank_kernel.fbank_kernel(wav, cfg).double()
    want = fbank_kernel.fbank_kernel_reference(wav, cfg).double()
    truth = _fbank_float64(wav, cfg)
    torch.testing.assert_close(got, truth, **FBANK_TOL)
    plain_ok = torch.isclose(want, truth, **FBANK_TOL)
    assert bool((torch.isclose(got, want, **FBANK_TOL) | ~plain_ok).all())


@pytest.mark.cuda
def test_fbank_kernel_rejects_bad_input(cuda):
    cfg = FbankConfig()
    with pytest.raises(TypeError):
        fbank_kernel.fbank_kernel(torch.zeros(1, 16000, device=cuda, dtype=torch.float16), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        fbank_kernel.fbank_kernel(torch.zeros(16000, 2, device=cuda).T, cfg)
    with pytest.raises(ValueError, match="frame"):
        fbank_kernel.fbank_kernel(torch.zeros(1, 300, device=cuda), cfg)
    # FFT sizes past the kernel's 256-2048: 4 kHz (100-sample frames, N =
    # 128) and 96 kHz (N = 4096)
    launches = fbank_kernel.LAUNCHES
    for rate in (4000, 96000):
        with pytest.raises(ValueError, match="FFT sizes"):
            fbank_kernel.fbank_kernel(torch.zeros(1, rate, device=cuda),
                                      FbankConfig(sample_rate=rate, num_mel_bins=23))
    assert fbank_kernel.LAUNCHES == launches


@pytest.mark.cuda
def test_service_on_gpu_matches_cpu(cuda, tmp_path):
    from wespeaker_hubert_tpu_torch.bin.serve import EmbeddingService
    from wespeaker_hubert_tpu_torch.models.registry import get_speaker_model
    from wespeaker_hubert_tpu_torch.train.chunked import make_chunked_embed

    config = {"model": "ECAPA_TDNN_GLOB_c512",
              "model_args": {"feat_dim": 40, "embed_dim": 16},
              "dataset_args": {"fbank_args": {"num_mel_bins": 40}}}
    (tmp_path / "config.json").write_text(json.dumps(config))
    torch.manual_seed(0)
    model = get_speaker_model(config["model"])(**config["model_args"]).eval()
    torch.save(model.state_dict(), tmp_path / "avg_model.pt")
    svc = EmbeddingService(str(tmp_path), device="cuda", max_batch=2,
                           max_seconds=2.0, chunk_frames=60, bf16=False)
    try:
        wav = _wav(1, (24000,)).numpy()
        launches = fbank_kernel.LAUNCHES
        got = svc.embed_samples(wav)
        assert fbank_kernel.LAUNCHES > launches
    finally:
        svc.close()
    padded = np.zeros((1, svc.bucket_for(len(wav))), np.float32)
    padded[0, : len(wav)] = wav
    want = make_chunked_embed(model, FbankConfig(num_mel_bins=40), 60)(
        {"wav": torch.from_numpy(padded), "length": torch.tensor([len(wav)])}
    )[0].numpy()
    cos = float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert cos >= 0.99999, cos


K2_TOL = {torch.float32: dict(atol=1e-4, rtol=0.0), torch.bfloat16: dict(atol=2e-2, rtol=0.0)}


def _attn_inputs(seed, b, t, h, dtype, device):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, 64)).astype(np.float32))
               .to(device, dtype) for _ in range(3))
    return q, k, v, rng


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "t,bias_shape,with_len",
    [(131, "full", True), (200, "padding", True), (64, "none", False),
     (77, "heads", False), (1, "full", True)],
    ids=["odd_T_full_bias_lengths", "broadcast_padding_bias", "no_bias",
         "broadcast_head_bias", "T_1"],
)
def test_flash_kernel_matches_plain(cuda, dtype, t, bias_shape, with_len):
    b, h = 3, 4
    q, k, v, rng = _attn_inputs(t, b, t, h, dtype, cuda)
    shape = {"full": (b, h, t, t), "padding": (b, 1, 1, t), "heads": (1, h, t, t),
             "none": None}[bias_shape]
    bias = None if shape is None else torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(cuda, dtype)
    key_len = torch.tensor([t, max(1, t // 2), max(1, t // 3)], device=cuda) if with_len else None
    launches = k2.LAUNCHES
    got = k2.flash_attention(q, k, v, bias=bias, key_len=key_len)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == launches + 1 and got.dtype == dtype and got.shape == q.shape
    want = k2.flash_attention_reference(q, k, v, bias, key_len)
    torch.testing.assert_close(got.float(), want.float(), **K2_TOL[dtype])
    cos = torch.nn.functional.cosine_similarity(got.float().flatten(), want.float().flatten(), dim=0)
    assert float(cos) >= 0.9999


GATED_T = [75, 99, 131, 499, 1599]


def _gated(rng, b, t, h, dtype, device, padded=True):
    """The (h, T, T) table (rows padded to 16 bytes, as the encoder builds
    it) and a (B, h, T) gate in [1, 3)."""
    tp = t + (-t % 8) if padded else t
    table = torch.from_numpy(rng.standard_normal((h, t, tp)).astype(np.float32)).to(device, dtype)
    gate = torch.from_numpy(rng.uniform(1.0, 3.0, (b, h, t)).astype(np.float32)).to(device, dtype)
    return table[..., :t], gate


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t", GATED_T)
def test_flash_kernel_factored_bias_matches_plain(cuda, dtype, t):
    """The gated bias formed in the kernel, random key lengths; no bias is
    copied (the table is TMA-readable as it is)."""
    b, h = 3, 4
    q, k, v, rng = _attn_inputs(50 + t, b, t, h, dtype, cuda)
    table, gate = _gated(rng, b, t, h, dtype, cuda)
    key_len = torch.from_numpy(rng.integers(1, t + 1, b)).to(cuda)
    launches, relayouts = k2.LAUNCHES, k2.BIAS_RELAYOUTS
    got = k2.flash_attention(q, k, v, bias=table, key_len=key_len, bias_gate=gate)
    torch.cuda.synchronize()
    assert (k2.LAUNCHES, k2.BIAS_RELAYOUTS) == (launches + 1, relayouts)
    want = k2.flash_attention_reference(q, k, v, table, key_len, bias_gate=gate)
    torch.testing.assert_close(got.float(), want.float(), **K2_TOL[dtype])
    assert _cos(got, want) >= 0.9999


@pytest.mark.cuda
def test_flash_kernel_strided_views(cuda):
    """q, k, v as views of one fused (B, T, 3, h, 64) projection: the kernel
    reads through the strides."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((2, 90, 3, 4, 64)).astype(np.float32)).to(cuda)
    q, k, v = qkv.unbind(2)
    got = k2.flash_attention(q, k, v)
    want = k2.flash_attention_reference(q, k, v)
    torch.testing.assert_close(got, want, **K2_TOL[torch.float32])


@pytest.mark.cuda
def test_flash_kernel_rejects_bad_input(cuda):
    q, k, v, _ = _attn_inputs(0, 2, 16, 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        k2.flash_attention(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(TypeError):
        k2.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="bias"):
        k2.flash_attention(q, k, v, bias=torch.zeros(2, 2, 16, 16, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        k2.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.empty(v.numel() + 1, device=cuda)[1:].view(v.shape)  # 4-byte offset
        k2.flash_attention(q, k, shifted)
    # bf16 goes through TMA: a row stride that is not a multiple of 16 bytes
    wide = torch.zeros(2, 16, 2, 68, device=cuda, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="aligned"):
        k2.flash_attention(wide, k.bfloat16(), v.bfloat16())
    shifted = torch.empty(v.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:].view(v.shape)
    with pytest.raises(ValueError, match="aligned"):
        k2.flash_attention(q.bfloat16(), k.bfloat16(), shifted)  # a 2-byte offset
    launches = k2.LAUNCHES
    k2.flash_attention(q, k, v, key_len=torch.tensor([16, 3], device=cuda))
    assert k2.LAUNCHES == launches + 1  # refusals never count


@pytest.mark.cuda
def test_wavlm_embedding_on_gpu_matches_cpu(cuda):
    """A tiny WavLM at head dim 64 (the kernel's) + a narrow ECAPA through
    make_eval_embed with lengths, K2 on the card against the plain path on
    the CPU, float32."""
    import dataclasses

    from wespeaker_hubert_tpu_torch.frontend import SSLEncoderConfig, SSLFrontend
    from wespeaker_hubert_tpu_torch.models.ecapa_tdnn import EcapaTdnn
    from wespeaker_hubert_tpu_torch.models.speaker_net import SpeakerNet
    from wespeaker_hubert_tpu_torch.train.executor import make_eval_embed

    cfg = dataclasses.replace(SSLEncoderConfig.tiny("wavlm"), hidden_size=128,
                              num_attention_heads=2, intermediate_size=256, attn_impl="flash")
    torch.manual_seed(0)
    net = SpeakerNet(EcapaTdnn(32, 128, 16, "ASTP", True), SSLFrontend(cfg)).eval()
    wav = _wav(5, (3, 40000))
    lengths = torch.tensor([40000, 25000, 9000], dtype=torch.int32)
    want = make_eval_embed(net)({"wav": wav, "length": lengths}).numpy()
    launches = k2.LAUNCHES
    got = make_eval_embed(net.to(cuda))({"wav": wav.to(cuda), "length": lengths.to(cuda)})
    assert k2.LAUNCHES - launches == cfg.num_hidden_layers
    got = got.cpu().numpy()
    cos = np.sum(got * want, 1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.99999, cos


def _cos(a, b):
    return float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0))


BWD_CASES = [
    # (B, T, h, bias shape, key lengths)
    (4, 75, 16, "full", None),          # the training shape, narrowed in B
    (3, 131, 4, "full", "random"),      # odd T, ragged tiles
    (3, 200, 4, "padding", "random"),   # a broadcast (B, 1, 1, T) bias
    (2, 64, 4, None, "random"),         # no bias
    (3, 77, 4, "heads", "empty"),       # (1, h, T, T) bias, a row of no valid key
    (2, 1, 2, "full", None),            # T = 1
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=["train", "odd_T", "padding_bias", "no_bias",
                                                 "head_bias_empty_row", "T_1"])
def test_flash_backward_matches_plain(cuda, dtype, case):
    b, t, h, bias_kind, len_kind = case
    q, k, v, rng = _attn_inputs(1000 + t, b, t, h, dtype, cuda)
    shape = {"full": (b, h, t, t), "padding": (b, 1, 1, t), "heads": (1, h, t, t),
             None: None}[bias_kind]
    bias = None if shape is None else torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(cuda, dtype)
    key_len = None
    if len_kind == "random":
        key_len = torch.from_numpy(rng.integers(1, t + 1, b)).to(cuda)
    elif len_kind == "empty":
        key_len = torch.tensor([t, 0, t // 2], device=cuda)
    out, lse = k2.flash_attention_fwd(q, k, v, bias, key_len, return_lse=True)
    _, lse_ref = k2.flash_attention_reference(q, k, v, bias, key_len, return_lse=True)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4 if dtype == torch.float32 else 2e-2,
                               rtol=0.0)
    dout = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(cuda, dtype)
    dkv, dq = k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_DQ
    got = k2.flash_attention_bwd(q, k, v, bias, key_len, None, out, lse, dout)
    torch.cuda.synchronize()
    assert (k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_DQ) == (dkv + 1, dq + 1)
    want = k2.flash_attention_bwd_reference(q, k, v, bias, key_len, None, out, lse, dout)
    for name, g, w in zip(("dq", "dk", "dv", "dbias", "dgate", "delta"), got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0.0, msg=name)
        elif float(w.float().abs().max()) > 0:
            assert _cos(g, w) >= 0.9999, (name, _cos(g, w))
    if len_kind == "empty":  # row 1 has no valid key: every gradient of it is 0
        assert float(got[0][1].abs().max()) == 0.0 and float(got[1][1].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t", GATED_T[:4])
def test_flash_backward_factored_bias_matches_plain(cuda, dtype, t):
    b, h = 3, 4
    q, k, v, rng = _attn_inputs(70 + t, b, t, h, dtype, cuda)
    table, gate = _gated(rng, b, t, h, dtype, cuda)
    key_len = torch.from_numpy(rng.integers(1, t + 1, b)).to(cuda)
    out, lse = k2.flash_attention_fwd(q, k, v, table, key_len, return_lse=True, bias_gate=gate)
    dout = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(cuda, dtype)
    got = k2.flash_attention_bwd(q, k, v, table, key_len, None, out, lse, dout, bias_gate=gate)
    torch.cuda.synchronize()
    want = k2.flash_attention_bwd_reference(q, k, v, table, key_len, None, out, lse, dout,
                                            bias_gate=gate)
    # the kernel's D and gate gradient, and the table's gradient from each dS
    pairs = list(zip(("dq", "dk", "dv", "ds", "dgate", "delta"), got, want))
    pairs.append(("dtable", k2.factored_bias_grads(got.dbias, table, gate),
                  k2.factored_bias_grads(want.dbias, table, gate)))
    for name, g, w in pairs:
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0.0, msg=name)
        else:
            assert _cos(g, w) >= 0.9999, (name, _cos(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [75, 131])
def test_flash_backward_ds_view_is_padded(cuda, dtype, t):
    """dS comes back as the [..., :T] view of rows padded to a multiple of 8
    (TMA's 16-byte strides), equal to the plain dS, with zeros at the keys
    past each row's key length: a row of no valid key, and at T = 131 a key
    tile wholly past key_len."""
    b, h = 3, 4
    q, k, v, rng = _attn_inputs(90 + t, b, t, h, dtype, cuda)
    table, gate = _gated(rng, b, t, h, dtype, cuda)
    key_len = torch.tensor([t, 0, 50], device=cuda)
    out, lse = k2.flash_attention_fwd(q, k, v, table, key_len, return_lse=True, bias_gate=gate)
    dout = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(cuda, dtype)
    ds = k2.flash_attention_bwd(q, k, v, table, key_len, None, out, lse, dout,
                                bias_gate=gate).dbias
    torch.cuda.synchronize()
    want = k2.flash_attention_bwd_reference(q, k, v, table, key_len, None, out, lse, dout,
                                            bias_gate=gate).dbias
    assert ds.shape == (b, h, t, t) and ds.stride() == (h * t * (t + -t % 8), t * (t + -t % 8),
                                                        t + -t % 8, 1)
    assert float(ds[1].abs().max()) == 0.0 and float(ds[2, ..., 50:].abs().max()) == 0.0
    if dtype == torch.float32:
        torch.testing.assert_close(ds, want, atol=1e-4, rtol=0.0)
    else:
        assert _cos(ds, want) >= 0.9999, _cos(ds, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_function_factored_grads_match_autograd(cuda, dtype):
    """The table's and the gate's gradients from the kernels' dS against
    autograd through the plain forward with the bias materialized."""
    b, t, h = 2, 75, 4
    q, k, v, rng = _attn_inputs(8, b, t, h, dtype, cuda)
    table, gate = _gated(rng, b, t, h, dtype, cuda)
    g = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(cuda, dtype)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, table, gate)]
    got = torch.autograd.grad(
        k2.flash_attention(*leaves[:4], bias_gate=leaves[4]), leaves, g)
    ref = [x.clone().requires_grad_() for x in (q, k, v, table, gate)]
    want = torch.autograd.grad(
        k2.flash_attention_reference(*ref[:3], ref[4][..., None] * ref[3][None]), ref, g)
    for name, a, w in zip(("dq", "dk", "dv", "dtable", "dgate"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4, msg=name)
        else:
            assert _cos(a, w) >= 0.999, (name, _cos(a, w))
    # the gate's gradient and D as the dQ kernel forms them, against the
    # plain backward of the same forward
    out, lse = k2.flash_attention_fwd(q, k, v, table, None, return_lse=True, bias_gate=gate)
    kern = k2.flash_attention_bwd(q, k, v, table, None, None, out, lse, g, bias_gate=gate)
    plain = k2.flash_attention_bwd_reference(q, k, v, table, None, None, out, lse, g,
                                             bias_gate=gate)
    for name in ("dgate", "delta"):
        a, w = getattr(kern, name), getattr(plain, name)
        assert a.shape == w.shape == (b, h, t) and a.dtype == w.dtype, name
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, atol=1e-4, rtol=0.0, msg=name)
        else:
            assert _cos(a, w) >= 0.9999, (name, _cos(a, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_function_grads_match_autograd(cuda, dtype):
    """The autograd Function (kernels both ways) against autograd through the
    plain forward, with a broadcast bias summed back to its shape."""
    b, t, h = 2, 90, 4
    q, k, v, rng = _attn_inputs(7, b, t, h, dtype, cuda)
    bias = torch.from_numpy(rng.standard_normal((b, 1, t, t)).astype(np.float32)).to(cuda, dtype)
    key_len = torch.tensor([t, 50], device=cuda)
    g = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(cuda, dtype)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
    launches = (k2.LAUNCHES, k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_DQ)
    got = torch.autograd.grad(k2.flash_attention(*leaves, key_len=key_len), leaves, g)
    assert (k2.LAUNCHES, k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_DQ) == tuple(
        n + 1 for n in launches)
    ref = [x.clone().requires_grad_() for x in (q, k, v, bias)]
    want = torch.autograd.grad(
        k2.flash_attention_reference(*ref, key_len=key_len), ref, g)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, atol=1e-4, rtol=0.0, msg=name)
        else:
            assert _cos(a, w) >= 0.9999, (name, _cos(a, w))


@pytest.mark.cuda
def test_flash_backward_rejects_bad_input(cuda):
    q, k, v, _ = _attn_inputs(3, 2, 16, 2, torch.float32, cuda)
    out, lse = k2.flash_attention_fwd(q, k, v, return_lse=True)
    launches = (k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_DQ)
    with pytest.raises(ValueError, match="head dim 64"):
        k2.flash_attention_bwd(q[..., :32], k[..., :32], v[..., :32], None, None, None,
                               out[..., :32], lse, out[..., :32])
    with pytest.raises(ValueError, match="dout"):
        k2.flash_attention_bwd(q, k, v, None, None, None, out, lse, out.bfloat16())
    with pytest.raises(ValueError):
        k2.flash_attention_bwd(q, k, v.cpu(), None, None, None, out, lse, out)
    with pytest.raises(ValueError, match="lse"):
        k2.flash_attention_bwd(q, k, v, None, None, None, out, lse.cpu(), out)
    with pytest.raises(ValueError, match="CPU"):
        k2.flash_attention_bwd(q.cpu(), k.cpu(), v.cpu(), None, None, None, out.cpu(),
                               lse.cpu(), out.cpu())
    assert (k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_DQ) == launches  # refusals never count


@pytest.mark.cuda
def test_train_step_bf16_on_gpu(cuda):
    """One bf16 make_train_step of a small WavLM (head dim 64, the kernels')
    + a narrow ECAPA + ArcMargin, with speed perturbation and packed
    augmentation: K2's forward, dK/dV and dQ launch once per layer, the
    loss is finite, the float32 master weights move, the BatchNorm
    statistics stay float32."""
    import dataclasses

    from wespeaker_hubert_tpu_torch.frontend import SSLEncoderConfig, SSLFrontend
    from wespeaker_hubert_tpu_torch.models.ecapa_tdnn import EcapaTdnn
    from wespeaker_hubert_tpu_torch.models.projections import ArcMarginProduct
    from wespeaker_hubert_tpu_torch.models.speaker_net import SpeakerNet
    from wespeaker_hubert_tpu_torch.ops.pipeline import FeaturePipelineConfig
    from wespeaker_hubert_tpu_torch.train.executor import make_train_step
    from wespeaker_hubert_tpu_torch.train.state import TrainState, make_optimizer

    cfg = dataclasses.replace(SSLEncoderConfig.tiny("wavlm", True), hidden_size=128,
                              num_attention_heads=2, intermediate_size=256, attn_impl="flash")
    torch.manual_seed(0)
    net = SpeakerNet(EcapaTdnn(32, 128, 16, "ASTP", True), SSLFrontend(cfg, frozen=False),
                     ArcMarginProduct(16, 6, 32.0)).to(cuda)
    state = TrainState(net, make_optimizer(net), lambda step: 1e-3)
    step = make_train_step(net, state.lr_schedule, lambda step: 0.2,
                           feature_cfg=FeaturePipelineConfig(spec_aug=True),
                           chunk_samples=8240, compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(4)
    batch = {"wav": torch.from_numpy((rng.standard_normal((4, 9100)) * 0.1).astype(np.float32)),
             "speed_idx": torch.tensor([0, 1, 2, 0], dtype=torch.int32),
             "label": torch.tensor([0, 3, 5, 1], dtype=torch.int32),
             "rir": torch.from_numpy((rng.standard_normal((1, 400)) * 0.1).astype(np.float32)),
             "noise": torch.from_numpy((rng.standard_normal((1, 8240)) * 0.1).astype(np.float32)),
             "snr": torch.tensor([5.0])}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    counts = (k2.LAUNCHES, k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_DQ)
    relayouts = k2.BIAS_RELAYOUTS
    metrics = step(state, batch)
    torch.cuda.synchronize()
    assert k2.BIAS_RELAYOUTS == relayouts  # the gated bias went in factored, TMA-readable
    assert (k2.LAUNCHES, k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_DQ) == tuple(
        n + cfg.num_hidden_layers for n in counts)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    for name, p in net.named_parameters():
        assert p.dtype == torch.float32, name
    moved = [k for k, p in net.named_parameters() if not torch.equal(p, before[k])]
    assert any("gru_rel_pos" in k for k in moved) and any("rel_attn_embed" in k for k in moved)
    assert net.backbone.bn.running_var.dtype == torch.float32


@pytest.mark.cuda
def test_scoring_on_gpu_matches_cpu(cuda, monkeypatch):
    """Trial cosine scores within 1e-5, cohort means and stds within 1e-6 and
    AS-Norm within 2e-4 of the CPU's, on seeded embeddings with speaker
    structure (600 utterances, 50 speakers, 192-d, top 30)."""
    from wespeaker_hubert_tpu_torch.backend import score

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((50, 192))
    spk = np.repeat(np.arange(50), 12)
    emb = (centers[spk] + 1.5 * rng.standard_normal((600, 192))).astype(np.float32)
    cohort = np.stack([emb[spk == s].mean(0) for s in range(50)]).astype(np.float32)
    e_idx, t_idx = rng.integers(0, 600, 5000), rng.integers(0, 600, 5000)
    mean_vec = emb.mean(0)
    monkeypatch.setattr(score, "COHORT_ROW_BLOCK", 256)  # several row blocks
    got = {}
    for dev in ("cuda", "cpu"):
        s = score.trial_cosine_scores(emb, e_idx, t_idx, mean_vec=mean_vec, device=dev)
        m, sd = score.cohort_mean_std(emb - mean_vec, cohort - mean_vec, 30, device=dev)
        got[dev] = (s, m, sd, score.apply_asnorm(s, e_idx, t_idx, m, sd, m, sd))
    for i, atol in enumerate((1e-5, 1e-6, 1e-6, 2e-4)):
        np.testing.assert_allclose(got["cuda"][i], got["cpu"][i], rtol=0, atol=atol)


@pytest.mark.cuda
def test_train_features_on_gpu_match_cpu(cuda):
    """The train branch of wav_to_features (dither 0, SpecAug off): the card
    (K1 on the dither-free batch) against the CPU's plain path, at K1's bar;
    with dither and SpecAug on, the card's result is finite and differs
    from the dither-free one."""
    from wespeaker_hubert_tpu_torch.ops.pipeline import FeaturePipelineConfig, wav_to_features

    wav = _wav(3, (4, 32240))
    lengths = torch.tensor([32240, 30000, 20000, 16400])
    cfg = FeaturePipelineConfig(fbank=FbankConfig(dither=0.0, spectrum_impl="kernel"),
                                spec_aug=False)
    out = {}
    for dev in ("cuda", "cpu"):
        g = torch.Generator(device=dev).manual_seed(7)
        feats, mask = wav_to_features(wav.to(dev), cfg, lengths=lengths.to(dev), train=True,
                                      generator=g)
        out[dev] = (feats.cpu().numpy(), mask.cpu().numpy())
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], **FBANK_TOL)
    noisy = FeaturePipelineConfig(fbank=FbankConfig(dither=1.0, spectrum_impl="kernel"),
                                  spec_aug=True, spec_aug_prob=1.0)
    g = torch.Generator(device="cuda").manual_seed(7)
    feats, _ = wav_to_features(wav.to(cuda), noisy, train=True, generator=g)
    feats = feats.cpu().numpy()
    assert np.isfinite(feats).all() and np.abs(feats - out["cuda"][0]).max() > 1e-3


def _resnet34_net(seed=11):
    """ResNet34 at its published widths (32 channels, 80 mels, 256-d, TSTP)
    with seeded random weights, float32, in eval."""
    from wespeaker_hubert_tpu_torch.models.speaker_net import SpeakerNet
    from wespeaker_hubert_tpu_torch.models.resnet import ResNet34

    net = SpeakerNet(ResNet34(80, 256))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for k, v in net.state_dict().items():
            if v.is_floating_point():
                scale = 0.1 if v.dim() == 1 else float(np.prod(v.shape[1:])) ** -0.5
                x = rng.normal(0.0, scale, v.shape)
                if k.endswith("running_var") or (k.endswith("weight") and v.dim() == 1):
                    x = rng.uniform(0.5, 1.5, v.shape)
                v.copy_(torch.from_numpy(x.astype(np.float32)))
    return net.eval()


@pytest.mark.cuda
def test_resnet34_embedding_on_gpu_matches_cpu(cuda):
    """ResNet34 embeddings of a padded batch with a mask through
    make_eval_embed (K1 on the card), the card against the CPU's plain path,
    float32 with TF32 off: cosine >= 0.99999."""
    from wespeaker_hubert_tpu_torch.ops.pipeline import FeaturePipelineConfig
    from wespeaker_hubert_tpu_torch.train.executor import make_eval_embed

    net = _resnet34_net()
    wav = _wav(6, (3, 48000))
    lengths = torch.tensor([48000, 30000, 12000], dtype=torch.int32)
    fcfg = FeaturePipelineConfig(fbank=FbankConfig(dither=0.0, spectrum_impl="kernel"),
                                 spec_aug=False)
    want = make_eval_embed(net, fcfg)({"wav": wav, "length": lengths}).numpy()
    launches = fbank_kernel.LAUNCHES
    got = make_eval_embed(net.to(cuda), fcfg)({"wav": wav.to(cuda), "length": lengths.to(cuda)})
    assert fbank_kernel.LAUNCHES - launches == 1
    got = got.cpu().numpy()
    assert got.shape == (3, 256) and np.isfinite(got).all()
    cos = np.sum(got * want, 1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.99999, cos


@pytest.mark.cuda
def test_exported_resnet34_program_on_gpu_matches_eager(cuda, tmp_path):
    """bin/export_model.export_program's torch.export program of ResNet34,
    loaded onto the card, against the eager model on the card at two (B, T)
    shapes: cosine >= 0.99999 (float32, TF32 off)."""
    from wespeaker_hubert_tpu_torch.bin.export_model import export_program, load_program

    net = _resnet34_net()
    config = {"model": "ResNet34", "model_args": {"feat_dim": 80, "embed_dim": 256}}
    torch.save(net.backbone.state_dict(), tmp_path / "avg_model.pt")
    program = load_program(export_program(config, str(tmp_path / "avg_model.pt"),
                                          str(tmp_path / "model.pt2")), device=cuda)
    net.to(cuda)
    for b, t in ((4, 200), (3, 517)):
        feats = _wav(b * t, (b, t, 80)).to(cuda) * 10
        with torch.inference_mode():
            got, want = program(feats), net.embed(feats)
        assert got.device == feats.device and got.shape == (b, 256)
        cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
        assert float(cos.min()) >= 0.99999, cos


@pytest.mark.cuda
@pytest.mark.parametrize("model,embed_dim,feat_dim", [
    ("CAMPPlus", 512, 80), ("Res2Net34_Base", 256, 80), ("ERes2Net34_Base", 512, 80),
    ("REPVGG_TINY_A0", 256, 80), ("XVEC", 512, 80), ("XI_VEC_ECAPA_TDNN_c512", 192, 80),
    ("Gemini_DF_ResNet114", 256, 80), ("SimAM_ResNet34_ASP", 256, 80), ("ReDimNetB2", 192, 72)])
def test_zoo_forward_on_gpu_matches_cpu(cuda, model, embed_dim, feat_dim):
    """The zoo at its published widths (80 mels; ReDimNet 72) with seeded
    random weights, in eval on a padded feature batch with a ragged mask (3
    x 317 frames; CAM++'s 159 frames after its TDNN end in a partial
    segment), the card against the CPU, float32 with TF32 off: cosine >=
    0.99999."""
    from wespeaker_hubert_tpu_torch.models.registry import get_speaker_model
    from wespeaker_hubert_tpu_torch.models.speaker_net import SpeakerNet

    net = SpeakerNet(get_speaker_model(model)(feat_dim, embed_dim))
    rng = np.random.default_rng(12)
    with torch.no_grad():
        for k, v in net.state_dict().items():
            if v.is_floating_point():
                scale = 0.1 if v.dim() == 1 else float(np.prod(v.shape[1:])) ** -0.5
                x = rng.normal(0.0, scale, v.shape)
                if k.endswith("running_var") or (k.endswith("weight") and v.dim() == 1):
                    x = rng.uniform(0.5, 1.5, v.shape)
                v.copy_(torch.from_numpy(x.astype(np.float32)))
    net.eval()
    feats = _wav(31, (3, 317, feat_dim)) * 10
    mask = torch.arange(317)[None, :] < torch.tensor([317, 200, 90])[:, None]
    with torch.inference_mode():
        want = net.embed(feats, mask).numpy()
        got = net.to(cuda).embed(feats.to(cuda), mask.to(cuda)).cpu().numpy()
    assert got.shape == (3, embed_dim) and np.isfinite(got).all()
    cos = np.sum(got * want, 1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.99999, cos


# ------------------------------------------------------------- Whisper
def _whisper_qkv(seed, b, t, dtype, device):
    """Whisper's K2 inputs: 20 heads of 64, q and k scaled by 64^-0.25 as the
    encoder scales them before the call (the call's scale is then 1.0)."""
    q, k, v, rng = _attn_inputs(seed, b, t, 20, dtype, device)
    s = 64 ** -0.25
    return (q.float() * s).to(dtype), (k.float() * s).to(dtype), v, rng


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t", [(16, 1500), (64, 251)], ids=["extract_30s", "train"])
def test_flash_kernel_whisper_shapes_match_plain(cuda, dtype, b, t):
    """K2's forward at Whisper-large-v2's shapes: no bias, no key lengths,
    scale 1.0."""
    q, k, v, _ = _whisper_qkv(b + t, b, t, dtype, cuda)
    launches = k2.LAUNCHES
    got = k2.flash_attention(q, k, v, bias=None, key_len=None, scale=1.0)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == launches + 1 and got.dtype == dtype
    want = k2.flash_attention_reference(q, k, v, None, None, 1.0)
    torch.testing.assert_close(got.float(), want.float(), **K2_TOL[dtype])
    assert _cos(got, want) >= 0.9999


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_backward_whisper_shape_matches_plain(cuda, dtype):
    """K2's dK/dV and dQ at the joint fine-tuning shape (16, 251, 20, 64),
    no bias, no key lengths, scale 1.0."""
    q, k, v, rng = _whisper_qkv(7, 16, 251, dtype, cuda)
    out, lse = k2.flash_attention_fwd(q, k, v, None, None, 1.0, return_lse=True)
    dout = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(cuda, dtype)
    dkv, dq = k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_DQ
    got = k2.flash_attention_bwd(q, k, v, None, None, 1.0, out, lse, dout)
    torch.cuda.synchronize()
    assert (k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_DQ) == (dkv + 1, dq + 1)
    want = k2.flash_attention_bwd_reference(q, k, v, None, None, 1.0, out, lse, dout)
    assert got.dbias is None and got.dgate is None
    for name, g, w in zip(("dq", "dk", "dv", "delta"), (got.dq, got.dk, got.dv, got.delta),
                          (want.dq, want.dk, want.dv, want.delta)):
        assert g.dtype == w.dtype and g.shape == w.shape and bool(torch.isfinite(g).all()), name
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0.0, msg=name)
        else:
            assert _cos(g, w) >= 0.9999, (name, _cos(g, w))


F32_CASES = [
    # (B, T, h, key lengths, max |S|): a partial last tile at T = 1,500 with a
    # ragged key length; the logits scaled to max |S| = 40, where 3xTF32's
    # relative error (about 2^-21 per product) is largest in absolute terms;
    # Whisper's joint fine-tuning shape narrowed in B
    (2, 1500, 3, [1500, 1037], None),
    (2, 251, 4, None, 40.0),
    (2, 251, 20, None, None),
]
# At max |S| = 40 the gradients reach |dK| of 30-50 and any float32 pipeline
# is about 1e-4 from float64 there; the plain backward given the kernel
# forward's out and lse, which rounds S otherwise than that forward, 2.7e-4.
# So there each gradient of the kernel pipeline (the kernel forward, then
# the kernel backward) is held to float64, at most LARGE_LOGIT_RATIO x the
# plain pipeline's distance (the plain forward, then the plain backward) or
# 1e-4, as chip_smoke.py's large-logit rows are.
LARGE_LOGIT_RATIO = 2.0


def attention_f64(q, k, v, key_len, scale, dout):
    """The function and its gradients in float64: out, dq, dk, dv."""
    q, k, v, do = (x.double() for x in (q, k, v, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if key_len is not None:
        valid = torch.arange(s.shape[-1], device=s.device)[None, :] < key_len[:, None]
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, -1).nan_to_num(0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    delta = (out * do).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v) - delta)
    return (out, torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale, torch.einsum("bhqk,bqhd->bkhd", p, do))


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_CASES, ids=["T1500_partial_tile", "large_logits",
                                                 "whisper_train_B2"])
def test_flash_f32_tf32x3_kernels_match_plain(cuda, case):
    """The float32 forward and dK/dV kernels (3xTF32 on wgmma) and dQ against
    their plain versions, scale 1.0 as Whisper calls them: atol 1e-4 (at max
    |S| = 40 the gradients against float64, LARGE_LOGIT_RATIO)."""
    b, t, h, lens, s_max = case
    q, k, v, rng = _attn_inputs(4000 + t + h, b, t, h, torch.float32, cuda)
    q, k = q * 64 ** -0.25, k * 64 ** -0.25  # as the encoder scales them
    if s_max is not None:  # q and k scaled alike to max |q k^T| = s_max
        peak = float(torch.einsum("bqhd,bkhd->bhqk", q, k).abs().max())
        q, k = q * (s_max / peak) ** 0.5, k * (s_max / peak) ** 0.5
    key_len = None if lens is None else torch.tensor(lens, device=cuda)
    launches = k2.LAUNCHES
    out, lse = k2.flash_attention_fwd(q, k, v, None, key_len, 1.0, return_lse=True)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == launches + 1
    want, lse_ref = k2.flash_attention_reference(q, k, v, None, key_len, 1.0, return_lse=True)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=0.0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0.0)
    dout = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(cuda)
    got = k2.flash_attention_bwd(q, k, v, None, key_len, 1.0, out, lse, dout)
    torch.cuda.synchronize()
    ref = k2.flash_attention_bwd_reference(q, k, v, None, key_len, 1.0, out, lse, dout)
    exact = dict(zip(("out", "dq", "dk", "dv"), attention_f64(q, k, v, key_len, 1.0, dout)))
    pipe = k2.flash_attention_bwd_reference(q, k, v, None, key_len, 1.0, want, lse_ref, dout)
    for name in ("dq", "dk", "dv", "delta"):
        g, w = getattr(got, name), getattr(ref, name)
        assert bool(torch.isfinite(g).all()), name
        if s_max is not None and name != "delta":
            err64 = float((g.double() - exact[name]).abs().max())
            plain64 = float((getattr(pipe, name).double() - exact[name]).abs().max())
            assert err64 <= max(1e-4, LARGE_LOGIT_RATIO * plain64), (name, err64, plain64)
        else:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0.0, msg=name)
    if lens is not None:  # keys past key_len: dK = dV = 0
        assert float(got.dk[1, lens[1]:].abs().max()) == 0.0
        assert float(got.dv[1, lens[1]:].abs().max()) == 0.0


@pytest.mark.cuda
def test_whisper_block_on_gpu_matches_cpu(cuda):
    """One full-width Whisper-large-v2 block (1280 wide, 20 heads, flash
    attention) on the card against the CPU's plain path, forward and the
    input's gradient, float32 with TF32 off."""
    from wespeaker_hubert_tpu_torch.frontend.whisper import WhisperEncoderConfig, _Block

    torch.manual_seed(0)
    block = _Block(WhisperEncoderConfig(attn_impl="flash"))
    x = _wav(8, (2, 251, 1280)) * 10
    x_cpu = x.clone().requires_grad_()
    want = block(x_cpu)
    want.square().sum().backward()
    block.to(cuda)
    x_gpu = x.to(cuda).requires_grad_()
    counts = k2.LAUNCHES, k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_DQ
    got = block(x_gpu)
    got.square().sum().backward()
    torch.cuda.synchronize()
    assert (k2.LAUNCHES, k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_DQ) == tuple(c + 1 for c in counts)
    torch.testing.assert_close(got.detach().cpu(), want.detach(), atol=2e-4, rtol=1e-3)
    assert _cos(x_gpu.grad.cpu(), x_cpu.grad) >= 0.99999


@pytest.mark.cuda
def test_whisper_log_mel_on_gpu_matches_cpu(cuda):
    """ops/whisper_mel on the card (cuFFT, the mel product with TF32 off)
    against the CPU: atol 1e-4, at the training chunk and a 40 s wav."""
    from wespeaker_hubert_tpu_torch.ops.whisper_mel import whisper_log_mel

    for shape in ((4, 80240), (1, 640000)):
        wav = _wav(shape[1], shape)
        got = whisper_log_mel(wav.to(cuda))
        want = whisper_log_mel(wav)
        assert got.shape == (shape[0], shape[1] // 160, 80)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0.0)


def _ssl_changes(before, after):
    return torch.cat([(after[k].double() - before[k].double()).flatten() for k in before])


def _ssl_snapshot(named):
    return {f"{prefix}.{k}": v.detach().float().cpu().clone() for prefix, module in named
            for k, v in module.state_dict().items() if v.is_floating_point()}


@pytest.mark.cuda
def test_dino_step_on_gpu_matches_cpu(cuda):
    """One DINO step (a tiny EcapaTdnn, out_dim 64, 4 x (2 x 40 + 2 x 20
    frames), features handed in, after the freeze) on the card against the
    CPU from the same weights, float32 with TF32 off: loss within 1e-5
    relative; the student's, the teacher's and the centre's changes within
    1e-4 relative L2."""
    from wespeaker_hubert_tpu_torch.models.ecapa_tdnn import EcapaTdnn
    from wespeaker_hubert_tpu_torch.ssl import (
        DINOHead,
        DINONet,
        cosine_schedule,
        create_dino_state,
        make_dino_train_step,
    )

    rng = np.random.default_rng(31)
    batch = {k: torch.from_numpy(rng.standard_normal((4, 2, t, 16)).astype(np.float32))
             for k, t in (("global_feat", 40), ("local_feat", 20))}
    torch.manual_seed(0)
    start = DINONet(EcapaTdnn(16, 16, 8, "ASTP", True), DINOHead(8, 64, 32, 8)).state_dict()
    out = {}
    for dev in ("cpu", "cuda"):
        torch.manual_seed(0)
        net = DINONet(EcapaTdnn(16, 16, 8, "ASTP", True), DINOHead(8, 64, 32, 8))
        net.load_state_dict(start)
        state = create_dino_state(net.to(dev), 64)
        state.step = 1
        step = make_dino_train_step(cosine_schedule(0.1, 0.01, 4), cosine_schedule(1e-2, 1e-2, 4),
                                    cosine_schedule(0.9, 1.0, 4), cosine_schedule(0.04, 0.07, 2),
                                    n_global=2, n_local=2, freeze_last_layer_steps=1)
        named = (("student", state.student), ("teacher", state.teacher))
        before = {**_ssl_snapshot(named), "center": state.center.cpu().clone()}
        loss = float(step(state, {k: v.to(dev) for k, v in batch.items()})["loss"])
        after = {**_ssl_snapshot(named), "center": state.center.cpu().clone()}
        out[dev] = (loss, _ssl_changes(before, after))
    (got_loss, got), (want_loss, want) = out["cuda"], out["cpu"]
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    assert float((got - want).norm() / want.norm()) <= 1e-4


@pytest.mark.cuda
def test_moco_step_on_gpu_matches_cpu(cuda):
    """Two MoCo steps (a tiny x-vector encoder, K 16, batch 4 x 2 views x
    40 frames, features handed in) on the card against the CPU from the
    same weights and queue, float32 with TF32 off: losses within 1e-5
    relative, the pointer 8, both encoders' changes and the queue within
    1e-4 relative L2."""
    from wespeaker_hubert_tpu_torch.bin.train_contrastive import _Encoder
    from wespeaker_hubert_tpu_torch.models.tdnn import XVEC
    from wespeaker_hubert_tpu_torch.ssl import create_moco_state, make_moco_train_step

    rng = np.random.default_rng(32)
    batches = [{k: torch.from_numpy(rng.standard_normal((4, 40, 16)).astype(np.float32))
                for k in ("query_feat", "key_feat")} for _ in range(2)]
    torch.manual_seed(0)
    start = _Encoder(XVEC(feat_dim=16, hid_dim=16, stats_dim=24, embed_dim=8)).state_dict()
    out = {}
    for dev in ("cpu", "cuda"):
        enc = _Encoder(XVEC(feat_dim=16, hid_dim=16, stats_dim=24, embed_dim=8))
        enc.load_state_dict(start)
        state = create_moco_state(enc.to(dev), 8, K=16, generator=torch.Generator().manual_seed(2))
        step = make_moco_train_step(m=0.9)
        named = (("q", state.encoder_q), ("k", state.encoder_k))
        before = {**_ssl_snapshot(named), "queue": state.queue.cpu().clone()}
        losses = [float(step(state, {k: v.to(dev) for k, v in b.items()})["loss"])
                  for b in batches]
        after = {**_ssl_snapshot(named), "queue": state.queue.cpu().clone()}
        out[dev] = (losses, _ssl_changes(before, after), state.queue_ptr)
    (got_loss, got, ptr), (want_loss, want, _) = out["cuda"], out["cpu"]
    assert ptr == 8
    for a, b in zip(got_loss, want_loss):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert float((got - want).norm() / want.norm()) <= 1e-4


def _tone_conversation(rng, seconds, n_spk):
    """Alternating tones of `n_spk` speakers with zero gaps, on the int16
    grid (chip_smoke.conversation's audio)."""
    parts, t, spk = [], 0.0, 0
    while t < seconds:
        n = int(rng.uniform(1.0, 3.0) * 16000)
        tt = np.arange(n) / 16000
        f0 = 150 + 90 * spk
        parts.append(0.3 * np.sin(2 * np.pi * f0 * tt) + 0.12 * np.sin(4.2 * np.pi * f0 * tt)
                     + 0.01 * rng.standard_normal(n))
        gap = int(rng.uniform(0.4, 0.9) * 16000)
        parts.append(np.zeros(gap))
        t += (n + gap) / 16000
        spk = (spk + 1 + int(rng.integers(n_spk - 1))) % n_spk
    wav = np.concatenate(parts)[: int(seconds * 16000)]
    return (np.round(np.clip(wav, -1, 1) * 32767) / 32768).astype(np.float32)


@pytest.mark.cuda
def test_fbank_kernel_on_zero_gapped_segment_buckets(cuda):
    """K1 on the diarization's own segment batches: energy-VAD segments of
    a zero-gapped conversation, 32 rows at power-of-two sample buckets
    (cli/speaker.py's batching), edges carrying the silent gaps.  K1
    within the bar of its plain version wherever that version meets a
    float64 log-mel, and of the float64 log-mel elsewhere."""
    from wespeaker_hubert_tpu_torch.cli.speaker import SEG_ROWS, _bucket_groups
    from wespeaker_hubert_tpu_torch.diar import energy_vad

    wav = _tone_conversation(np.random.default_rng(4), 90.0, 3)
    segs = [wav[max(int(b * 16000) - 4000, 0): int(e * 16000) + 4000]
            for b, e in energy_vad(wav, 16000)]
    cfg = FbankConfig(spectrum_impl="kernel")
    groups = _bucket_groups([len(s) for s in segs])
    assert len(groups) >= 2
    for bucket, idx in groups:
        batch = np.zeros((SEG_ROWS, bucket), np.float32)
        for row, j in enumerate(idx):
            batch[row, : len(segs[j])] = segs[j]
        x = torch.from_numpy(batch).to(cuda)
        got = fbank_kernel.fbank_kernel(x, cfg).double()
        want = fbank_kernel.fbank_kernel_reference(x, cfg).double()
        truth = _fbank_float64(x, cfg)
        plain_ok = torch.isclose(want, truth, **FBANK_TOL)
        held = torch.where(plain_ok, torch.isclose(got, want, **FBANK_TOL),
                           torch.isclose(got, truth, **FBANK_TOL))
        assert bool(held.all()) and bool(torch.isfinite(got).all()), (bucket, int((~held).sum()))


@pytest.mark.cuda
def test_silero_on_gpu_matches_cpu(cuda):
    """Silero's probabilities (the STFT projection, the encoder convs and
    cuDNN's LSTM) on the card against the CPU within 1e-5, one
    conversation alone and in a batch."""
    from wespeaker_hubert_tpu_torch.diar.silero import (SileroVAD, silero_init_params,
                                                        silero_probs, silero_probs_batch)

    params = silero_init_params(np.random.default_rng(3))
    card, cpu = SileroVAD.from_params(params, cuda), SileroVAD.from_params(params)
    rng = np.random.default_rng(5)
    wavs = [_tone_conversation(rng, s, 2) for s in (3.0, 37.0, 61.0)]
    batched = silero_probs_batch(card, wavs)
    for w, b in zip(wavs, batched):
        want = silero_probs(cpu, w)
        np.testing.assert_allclose(silero_probs(card, w), want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(b, silero_probs(card, w))


@pytest.mark.cuda
def test_spectral_device_matches_host_on_gpu(cuda):
    """The spectral path on the card (similarity, prune, Laplacian,
    torch.linalg.eigh) against the host's at a fixed speaker count, 2,100
    windows: the same partition; 'auto' takes the card there."""
    from wespeaker_hubert_tpu_torch.diar import spectral

    rng = np.random.default_rng(6)
    centers = rng.standard_normal((4, 64))
    emb = np.concatenate([c + 0.15 * np.linalg.norm(c) * rng.standard_normal((525, 64)) / 8
                          for c in centers]).astype(np.float32)
    host = spectral.cluster(emb, num_spks=4, seed=1, impl="host")
    dev = spectral.cluster(emb, num_spks=4, seed=1, impl="device", device=cuda)
    auto = spectral.cluster(emb, num_spks=4, seed=1, impl="auto", device=cuda)
    for got in (dev, auto):
        assert len(set(zip(host, got))) == len(set(host)) == len(set(got)) == 4
    vals, _ = spectral._spectral_eigh_device(emb, 0.01, cuda)
    lap = spectral._laplacian(spectral._prune(spectral._cosine_similarity(emb), 0.01))
    import scipy.linalg

    np.testing.assert_allclose(vals[:8], scipy.linalg.eigh(lap)[0][:8], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_plda_on_gpu_matches_cpu(cuda):
    """Two-covariance PLDA (float64) trained, scored with multisession
    counts and adapted on the card against the same code on the CPU: psi
    within 1e-9 relative, scores within 1e-6 absolute (cuSOLVER's and
    LAPACK's eigenvectors may differ in sign; scores do not see it)."""
    from wespeaker_hubert_tpu_torch.backend.plda import TwoCovPLDA

    rng = np.random.default_rng(7)
    centres = 2.0 * rng.standard_normal((200, 64))
    labels = rng.integers(0, 200, 3000)
    emb = (centres[labels] + rng.standard_normal((3000, 64))).astype(np.float32)
    enroll = {f"m{i}": rng.standard_normal((1 + i % 3, 64)) for i in range(40)}
    test = {f"t{i}": rng.standard_normal(64) for i in range(50)}
    trials = [(e, t) for e in enroll for t in test]
    adp = 1.3 * rng.standard_normal((500, 64)) + 0.2
    out = {}
    for dev in (cuda, "cpu"):
        plda = TwoCovPLDA(64, normalize_length=True, device=dev).train_rows(emb, labels, 5)
        adapted = plda.adapt(adp)
        out[str(dev)] = (plda.psi.cpu().numpy(),
                         plda.score_trials(enroll, test, trials, multisession_avg=False),
                         adapted.score_trials(enroll, test, trials), adapted.adapt_info)
    card, cpu = out[str(cuda)], out["cpu"]
    assert np.linalg.norm(card[0] - cpu[0]) <= 1e-9 * np.linalg.norm(cpu[0])
    np.testing.assert_allclose(card[1], cpu[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(card[2], cpu[2], rtol=0, atol=1e-6)
    assert card[3]["n_above_1"] == cpu[3]["n_above_1"]


@pytest.mark.cuda
def test_compute_feats_on_k1_matches_plain(cuda, tmp_path):
    """bin/tools compute_feats on the card runs K1 (one launch per
    utterance) and writes what the plain path writes on the CPU, within
    K1's bar, with equal frame counts."""
    from wespeaker_hubert_tpu_torch.backend.kaldi_io import read_kaldi_matrices
    from wespeaker_hubert_tpu_torch.bin import tools
    from wespeaker_hubert_tpu_torch.data.wav_io import write_wav

    rng = np.random.default_rng(8)
    rows = []
    for i, n in enumerate((7000, 16000, 40321)):
        write_wav(str(tmp_path / f"u{i}.wav"), (0.1 * rng.standard_normal(n)).astype(np.float32))
        rows.append(f"u{i} {tmp_path / f'u{i}.wav'}")
    (tmp_path / "wav.scp").write_text("\n".join(rows) + "\n")
    launches = fbank_kernel.LAUNCHES
    for dev in ("cuda", "cpu"):
        tools.compute_feats(str(tmp_path / "wav.scp"), str(tmp_path / f"{dev}.ark"),
                            str(tmp_path / f"{dev}.scp"), device=dev)
    assert fbank_kernel.LAUNCHES == launches + 3
    got = read_kaldi_matrices(str(tmp_path / "cuda.ark"))
    want = read_kaldi_matrices(str(tmp_path / "cpu.ark"))
    for (k, g), (kw, w) in zip(got, want):
        assert k == kw and g.shape == w.shape
        np.testing.assert_allclose(g, w, **FBANK_TOL)


HEADS = {"add_margin": {}, "arc_margin_intertopk_subcenter": {"K": 3},
         "sphere": {"margin": 4}, "sphereface2": {"margin_type": "A"}, "linear": {}}


@pytest.mark.cuda
@pytest.mark.parametrize("ptype", sorted(HEADS))
def test_head_on_gpu_matches_cpu(cuda, ptype):
    """Each head the port adds, forward and backward, the card against the
    CPU in float32: logits and the gradients of a fixed projection of them
    (plus SphereFace2's loss) with respect to the embedding and every head
    parameter, at 8,400 classes (CN-Celeb's 3 x 2,800)."""
    from wespeaker_hubert_tpu_torch.models.projections import get_projection

    torch.manual_seed(0)
    conf = dict(HEADS[ptype], project_type=ptype, embed_dim=256, num_class=8400)
    heads = {d: get_projection(conf) for d in ("cpu", "cuda")}
    heads["cuda"].load_state_dict(heads["cpu"].state_dict())
    rng = np.random.default_rng(3)
    emb = torch.from_numpy(rng.standard_normal((16, 256)).astype(np.float32))
    label = torch.from_numpy(rng.integers(0, 8400, 16))
    proj = torch.from_numpy(rng.standard_normal((16, 8400)).astype(np.float32))
    got = {}
    for dev, head in heads.items():
        head.to(dev).train()
        e = emb.to(dev).detach().requires_grad_()
        logits, aux = head(e, label.to(dev), 0.2)
        out = (logits * proj.to(dev)).sum() + (0.0 if aux is None else aux)
        out.backward()
        got[dev] = [logits.detach().cpu(), e.grad.cpu()] + [
            p.grad.cpu() for p in head.parameters()] + ([aux.detach().cpu()] if aux is not None
                                                       else [])
    for a, b in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["MHASTP", "MQMHASTP"])
def test_multi_head_pooling_on_gpu_matches_cpu(cuda, pool):
    """MHASTP and MQMHASTP at ResNet34's pooled width (2,560 = 256 channels
    x 10 frequency rows) with a padding mask, forward and backward, the
    card against the CPU in float32."""
    from wespeaker_hubert_tpu_torch.models.pooling import POOLING_LAYERS

    torch.manual_seed(0)
    mods = {d: POOLING_LAYERS[pool](2560) for d in ("cpu", "cuda")}
    mods["cuda"].load_state_dict(mods["cpu"].state_dict())
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 2560, 50)).astype(np.float32))
    mask = torch.arange(50)[None, :] < torch.tensor([50, 41, 23, 7])[:, None]
    got = {}
    for dev, mod in mods.items():
        mod.to(dev)
        xd = x.to(dev).detach().requires_grad_()
        y = mod(xd, mask.to(dev))
        (y * torch.linspace(-1, 1, y.shape[-1], device=dev)).sum().backward()
        got[dev] = [y.detach().cpu(), xd.grad.cpu()] + [p.grad.cpu() for p in mod.parameters()]
    for a, b in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
