"""Port parity for the serving slice: chunked extraction and the eval
executor against the JAX package with shared weights, then the port's
EmbeddingService on the CPU behind a real HTTP server.

Float32 throughout, at the ECAPA tolerance (rtol 1e-4 / atol 1e-4 *
max|ref|); the served embeddings must equal the direct chunked path's up to
float32 summation order (1e-5)."""

import io
import json
import os
import threading
import urllib.error
import urllib.request
import wave
from http.server import ThreadingHTTPServer

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_ecapa import random_variables
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from wespeaker_hubert_tpu.models import get_speaker_model as jax_get_model
from wespeaker_hubert_tpu.models.speaker_net import SpeakerNet as JaxSpeakerNet
from wespeaker_hubert_tpu.ops.fbank import FbankConfig as JaxFbankConfig
from wespeaker_hubert_tpu.ops.pipeline import FeaturePipelineConfig as JaxFeaturePipelineConfig
from wespeaker_hubert_tpu.train import make_eval_embed as jax_make_eval_embed
from wespeaker_hubert_tpu.train.chunked import chunk_features as jax_chunk_features
from wespeaker_hubert_tpu.train.chunked import make_chunked_embed as jax_chunked
from wespeaker_hubert_tpu_torch.bin.serve import BOUNDARY, EmbeddingService, _make_handler
from wespeaker_hubert_tpu_torch.cli.speaker import Speaker
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables
from wespeaker_hubert_tpu_torch.models.registry import get_speaker_model
from wespeaker_hubert_tpu_torch.models.speaker_net import SpeakerNet
from wespeaker_hubert_tpu_torch.ops.fbank import FbankConfig
from wespeaker_hubert_tpu_torch.ops.pipeline import FeaturePipelineConfig
from wespeaker_hubert_tpu_torch.train.chunked import chunk_features, make_chunked_embed
from wespeaker_hubert_tpu_torch.train.executor import make_eval_embed

MODEL = "ECAPA_TDNN_GLOB_c512"
FEAT_DIM, EMBED_DIM, CHUNK = 40, 16, 60
SR = 16000


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=1e-4, atol=1e-4 * np.abs(want).max()
    )


def _wav(seed, n):
    """Samples on the int16 grid, so a PCM16 WAV round trip is exact."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-3000, 3000, n) / 32768.0).astype(np.float32)


def _wav_bytes(wav):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.round(wav * 32768).astype("<i2").tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def shared():
    jmodel = jax_get_model(MODEL)(feat_dim=FEAT_DIM, embed_dim=EMBED_DIM)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, CHUNK, FEAT_DIM)),
                            train=False)
    )
    variables = random_variables(shapes, seed=3)
    pmodel = get_speaker_model(MODEL)(feat_dim=FEAT_DIM, embed_dim=EMBED_DIM).eval()
    pmodel.load_state_dict(from_jax_variables(MODEL, variables))
    lengths = np.array([int(0.8 * SR), int(2.5 * SR), 4 * SR], np.int32)
    wav = np.zeros((3, 4 * SR), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = _wav(10 + i, n)
    return dict(jmodel=jmodel, variables=variables, pmodel=pmodel,
                wav=wav, lengths=lengths)


@pytest.mark.parametrize("feat_len", [[250, 120, 0], [59, 60, 61]])
def test_chunk_features_matches_jax(feat_len):
    feats = np.random.default_rng(0).standard_normal((3, 250, 4)).astype(np.float32)
    lens = np.array(feat_len, np.int32)
    want = jax.vmap(lambda f, n: jax_chunk_features(f, n, CHUNK, 5))(
        jnp.asarray(feats), jnp.asarray(lens)
    )
    got = chunk_features(torch.from_numpy(feats), torch.from_numpy(lens), CHUNK, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chunked_embed_matches_jax(shared):
    want = jax_chunked(
        shared["jmodel"], JaxFbankConfig(num_mel_bins=FEAT_DIM), CHUNK
    )(shared["variables"], {"wav": jnp.asarray(shared["wav"]),
                            "length": jnp.asarray(shared["lengths"])})
    got = make_chunked_embed(shared["pmodel"], FbankConfig(num_mel_bins=FEAT_DIM), CHUNK)(
        {"wav": torch.from_numpy(shared["wav"]),
         "length": torch.from_numpy(shared["lengths"])}
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, EMBED_DIM)
    _close(got.numpy(), want)


def test_eval_embed_feat_batch_matches_jax(shared):
    feats = np.random.default_rng(4).standard_normal((3, 90, FEAT_DIM)).astype(np.float32)
    flen = np.array([90, 47, 12], np.int32)
    jnet = JaxSpeakerNet(backbone=shared["jmodel"], projection=fnn.Dense(2))
    v = shared["variables"]
    jvars = {"params": {"backbone": v["params"]},
             "batch_stats": {"backbone": v["batch_stats"]}}
    want = jax_make_eval_embed(jnet)(
        jvars, {"feat": jnp.asarray(feats), "feat_length": jnp.asarray(flen)}
    )
    got = make_eval_embed(SpeakerNet(shared["pmodel"]))(
        {"feat": torch.from_numpy(feats), "feat_length": torch.from_numpy(flen)}
    )
    _close(got.numpy(), want)


def test_eval_embed_wav_batch_matches_jax(shared):
    jnet = JaxSpeakerNet(backbone=shared["jmodel"], projection=fnn.Dense(2))
    v = shared["variables"]
    jvars = {"params": {"backbone": v["params"]},
             "batch_stats": {"backbone": v["batch_stats"]}}
    jcfg = JaxFeaturePipelineConfig(
        fbank=JaxFbankConfig(num_mel_bins=FEAT_DIM, spectrum_impl="pallas"),
        spec_aug=False,
    )
    want = jax_make_eval_embed(jnet, feature_cfg=jcfg)(
        jvars, {"wav": jnp.asarray(shared["wav"]),
                "length": jnp.asarray(shared["lengths"])}
    )
    cfg = FeaturePipelineConfig(
        fbank=FbankConfig(num_mel_bins=FEAT_DIM, spectrum_impl="kernel"),
        spec_aug=False,
    )
    got = make_eval_embed(SpeakerNet(shared["pmodel"]), feature_cfg=cfg)(
        {"wav": torch.from_numpy(shared["wav"]),
         "length": torch.from_numpy(shared["lengths"])}
    )
    _close(got.numpy(), want)


@pytest.fixture(scope="module")
def model_dir(shared, tmp_path_factory):
    root = tmp_path_factory.mktemp("port_model")
    config = {
        "model": MODEL,
        "model_args": {"feat_dim": FEAT_DIM, "embed_dim": EMBED_DIM},
        "dataset_args": {"resample_rate": SR, "fbank_args": {"num_mel_bins": FEAT_DIM}},
    }
    (root / "config.json").write_text(json.dumps(config))
    sd = dict(shared["pmodel"].state_dict())
    sd["projection.weight"] = torch.zeros(2, EMBED_DIM)  # skipped on load
    torch.save(sd, root / "avg_model.pt")
    return str(root)


@pytest.fixture(scope="module")
def server(model_dir):
    service = EmbeddingService(
        model_dir, device="cpu", max_batch=4, batch_window_ms=20.0,
        max_seconds=4.0, chunk_frames=CHUNK, bf16=False,
    )
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(service))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", service
    httpd.shutdown()
    httpd.server_close()
    service.close()
    t.join(timeout=10)
    assert not t.is_alive()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _direct(service, shared, wav):
    """The served embedding computed directly: the same bucket padding."""
    n = len(wav)
    padded = np.zeros((1, service.bucket_for(n)), np.float32)
    padded[0, :n] = wav
    fn = make_chunked_embed(shared["pmodel"], FbankConfig(num_mel_bins=FEAT_DIM), CHUNK)
    return fn({"wav": torch.from_numpy(padded),
               "length": torch.tensor([n], dtype=torch.int32)})[0].numpy()


def test_embed_endpoint_equals_direct_and_jax(server, shared):
    url, service = server
    i = 1  # the 2.5 s utterance
    wav = shared["wav"][i, : shared["lengths"][i]]
    out = np.asarray(_post(url + "/embed", _wav_bytes(wav))["embedding"], np.float32)
    np.testing.assert_allclose(out, _direct(service, shared, wav), rtol=1e-5, atol=1e-6)
    padded = np.zeros((1, service.bucket_for(len(wav))), np.float32)
    padded[0, : len(wav)] = wav
    want = jax_chunked(shared["jmodel"], JaxFbankConfig(num_mel_bins=FEAT_DIM), CHUNK)(
        shared["variables"],
        {"wav": jnp.asarray(padded), "length": jnp.asarray([len(wav)])},
    )
    _close(out[None], want)


def test_concurrent_similarity_is_batching_independent(server):
    url, service = server
    a, b = _wav_bytes(_wav(20, SR)), _wav_bytes(_wav(21, 3 * SR // 2))
    results, errors = [], []

    def call():
        try:
            results.append(_post(url + "/similarity", a + BOUNDARY + b)["similarity"])
        except Exception as e:  # noqa: BLE001 — surfaced by the asserts
            errors.append(e)

    threads = [threading.Thread(target=call) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(results) == 6
    assert all(0.0 <= s <= 1.0 for s in results)
    assert max(results) - min(results) < 1e-6
    stats = _get(url + "/stats")
    assert stats["total_steps"] >= 12 and stats["device"] == "cpu"


def test_kserve_models(server, shared):
    url, service = server
    assert _get(url + "/v2/health/ready") == {}
    meta = _get(url + "/v2/models/speaker")
    assert meta["outputs"][0]["shape"] == [1, EMBED_DIM]
    wav = _wav(30, SR)

    body = {"inputs": [{"name": "WAV", "shape": [1, len(wav)], "datatype": "FP32",
                        "data": wav.tolist()}]}
    out = _post(url + "/v2/models/speaker/infer", json.dumps(body).encode())
    emb = np.asarray(out["outputs"][0]["data"], np.float32)
    assert out["outputs"][0]["name"] == "EMBEDDINGS"
    np.testing.assert_allclose(emb, _direct(service, shared, wav), rtol=1e-5, atol=1e-6)

    body = {"inputs": [{"name": "wav", "shape": [1, len(wav)], "datatype": "FP32",
                        "data": wav.tolist()}]}
    out = _post(url + "/v2/models/feature_extractor/infer", json.dumps(body).encode())
    speech = out["outputs"][0]
    feats = np.asarray(speech["data"], np.float32).reshape(speech["shape"])
    assert feats.shape == (98, FEAT_DIM)
    np.testing.assert_allclose(feats.mean(axis=0), 0.0, atol=1e-4)

    body = {"inputs": [{"name": "feats", "shape": list(feats.shape), "datatype": "FP32",
                        "data": feats.ravel().tolist()}]}
    out = _post(url + "/v2/models/speaker_model/infer", json.dumps(body).encode())
    embs = np.asarray(out["outputs"][0]["data"], np.float32)
    padded = np.zeros((1, 128, FEAT_DIM), np.float32)  # the service's T bucket
    padded[0, : len(feats)] = feats
    want = make_eval_embed(SpeakerNet(shared["pmodel"]))(
        {"feat": torch.from_numpy(padded),
         "feat_length": torch.tensor([len(feats)], dtype=torch.int32)}
    )[0].numpy()
    np.testing.assert_allclose(embs, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path", ["/diarize", "/v2/models/run/infer"])
def test_diarize_endpoints_refuse_malformed_requests(server, path):
    """/diarize and the KServe `run` model answer (tests/test_torch_port_diarize.py
    holds their results); a body that is no WAV, or no `input` tensor, is a 400."""
    url, _ = server
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url + path, b"{}")
    assert err.value.code == 400
    assert "error" in json.loads(err.value.read())


def test_grpc_is_refused(model_dir):
    from wespeaker_hubert_tpu_torch.bin.serve import serve

    with pytest.raises(NotImplementedError, match="gRPC"):
        serve(model_dir, port=0, grpc_port=8001, device="cpu")


def test_speaker_default_device_needs_cuda(model_dir):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbeddingService(model_dir)
    with pytest.raises(RuntimeError, match="CUDA"):
        Speaker(model_dir)


def test_speaker_refuses_missing_weights(model_dir, tmp_path):
    sd = torch.load(os.path.join(model_dir, "avg_model.pt"), weights_only=True)
    del sd["linear.weight"]
    torch.save(sd, tmp_path / "avg_model.pt")
    (tmp_path / "config.json").write_text(
        open(os.path.join(model_dir, "config.json")).read()
    )
    with pytest.raises(KeyError, match="linear.weight"):
        Speaker(str(tmp_path), device="cpu")


def test_speaker_api(model_dir, tmp_path):
    from wespeaker_hubert_tpu_torch.data.wav_io import write_wav

    spk = Speaker(model_dir, device="cpu")
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    write_wav(str(a), _wav(40, SR))
    write_wav(str(b), _wav(41, SR))
    assert spk.compute_similarity(str(a), str(a)) == pytest.approx(1.0, abs=1e-6)
    spk.register("alice", str(a))
    spk.register("bob", str(b))
    assert spk.recognize(str(b))["name"] == "bob"
