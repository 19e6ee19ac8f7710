"""The port's CUDA kernels and served path on a GPU (`cuda` marker; they
skip without one).  This file imports no JAX, and tests/conftest.py does,
so on a machine without JAX run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py

K1 against its plain version: rtol 1e-4 / atol 2e-3, the bar of the JAX
package's Pallas fbank.  K2 (flash attention) against its plain version:
float32 atol 1e-4 (float32 sums in another order); bf16 against the plain
bf16 path compared in float32, atol 2e-2 and cosine >= 0.9999 (the kernel
rounds the unnormalized probabilities to bf16 before P V, the plain version
the normalized ones).  Float32 embeddings cosine >= 0.99999 against the CPU
(TF32 off)."""

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
     ((2, 16000), {"sample_rate": 8000})],
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
    # fbank() routes dither-free CUDA log-mel batches to the kernel, and the
    # step-by-step plain path agrees with it
    routed, _ = fbank(wav, cfg)
    assert fbank_kernel.LAUNCHES == launches + 2
    plain, _ = fbank(wav.cpu(), FbankConfig(**kw))
    torch.testing.assert_close(routed.cpu(), plain, **FBANK_TOL)
    # a linear mel (use_log=False) is not the kernel's: the plain path
    fbank(wav, FbankConfig(spectrum_impl="kernel", use_log=False, **kw))
    assert fbank_kernel.LAUNCHES == launches + 2


@pytest.mark.cuda
def test_fbank_kernel_rejects_bad_input(cuda):
    cfg = FbankConfig()
    with pytest.raises(TypeError):
        fbank_kernel.fbank_kernel(torch.zeros(1, 16000, device=cuda, dtype=torch.float16), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        fbank_kernel.fbank_kernel(torch.zeros(16000, 2, device=cuda).T, cfg)
    with pytest.raises(ValueError, match="frame"):
        fbank_kernel.fbank_kernel(torch.zeros(1, 300, device=cuda), cfg)


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
