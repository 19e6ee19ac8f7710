"""The port's CUDA kernels and served path on a GPU (`cuda` marker; they
skip without one).  This file imports no JAX, and tests/conftest.py does,
so on a machine without JAX run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py

Kernel against its plain version: rtol 1e-4 / atol 2e-3, the bar of the
JAX package's Pallas fbank; float32 embeddings cosine >= 0.99999 against
the CPU (TF32 off)."""

import json

import numpy as np
import pytest
import torch

from wespeaker_hubert_tpu_torch.ops import fbank_kernel
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
