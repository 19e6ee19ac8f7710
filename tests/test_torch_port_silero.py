"""Port parity for Silero VAD (wespeaker_hubert_tpu_torch/diar/silero.py):
probabilities against the JAX package's `silero_probs` at seeded
`silero_init_params` within 1e-5, batched equal to single, causal bucket
padding, the speech-timestamp state machine equal to JAX's, and the
parameter tree through the npz files and models/convert_jax.py."""

import numpy as np
import pytest
import torch

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from wespeaker_hubert_tpu.diar import silero as jsilero
from wespeaker_hubert_tpu.diar.sad import system_sad as jsystem_sad
from wespeaker_hubert_tpu_torch.diar import silero as psilero
from wespeaker_hubert_tpu_torch.diar.sad import system_sad
from wespeaker_hubert_tpu_torch.models.convert_jax import silero_state_from_jax

PARAMS = jsilero.silero_init_params(np.random.default_rng(3))


@pytest.fixture(scope="module")
def model():
    return psilero.SileroVAD.from_params(PARAMS)


def _speechy(rng, seconds):
    """Noise bursts and silences, so the probabilities cross thresholds."""
    parts, t = [], 0.0
    while t < seconds:
        n = int(rng.uniform(0.2, 1.2) * 16000)
        amp = float(rng.choice([0.0, 0.02, 0.3]))
        parts.append((amp * rng.standard_normal(n)).astype(np.float32))
        t += n / 16000
    return np.concatenate(parts)[: int(seconds * 16000)]


@pytest.mark.parametrize("seconds", [1.0, 3.7, 10.0])
def test_probs_match_jax(model, seconds):
    wav = (np.random.default_rng(int(seconds * 10)).standard_normal(int(seconds * 16000))
           * 0.1).astype(np.float32)
    want = jsilero.silero_probs(PARAMS, wav)
    got = psilero.silero_probs(model, wav)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_batch_equals_single(model):
    rng = np.random.default_rng(0)
    wavs = [(rng.standard_normal(int(s * 16000)) * 0.1).astype(np.float32)
            for s in (1.2, 4.7, 4.7, 9.3, 0.01)]
    batched, batches, locs = psilero.silero_probs_batch(model, wavs, return_device=True)
    for j, (w, got) in enumerate(zip(wavs, batched)):
        np.testing.assert_array_equal(got, psilero.silero_probs(model, w))
        b, row = locs[j]
        np.testing.assert_array_equal(batches[b][row, : len(w)].numpy(), w)
    np.testing.assert_allclose(batched[3], jsilero.silero_probs_batch(PARAMS, wavs)[3],
                               rtol=0, atol=1e-5)


def test_bucket_padding_is_causal(model):
    """Trailing silence (the same bucket, and across bucket boundaries)
    leaves the real chunks' probabilities as they were."""
    wav = (np.random.default_rng(7).standard_normal(16000) * 0.1).astype(np.float32)
    base = psilero.silero_probs(model, wav)
    for extra in (512, 16000, 40000):
        got = psilero.silero_probs(model, np.concatenate([wav, np.zeros(extra, np.float32)]))
        np.testing.assert_allclose(got[: len(base)], base, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_speech_timestamps_match_jax(model, seed):
    wav = _speechy(np.random.default_rng(seed), 12.0)
    jvad = jsilero.SileroVAD(PARAMS)
    for kw in ({}, {"threshold": 0.18}, {"threshold": 0.3, "max_speech_duration_s": 2.0},
               {"return_seconds": True}):
        assert psilero.get_speech_timestamps(wav, model, **kw) == \
            jsilero.get_speech_timestamps(wav, jvad, **kw)
    # the state machine on given probabilities alone
    probs = np.random.default_rng(seed).uniform(size=400).astype(np.float32)
    probs = np.convolve(probs, np.ones(9) / 9, mode="same")
    wav = np.zeros(400 * psilero.WINDOW, np.float32)
    for kw in ({}, {"threshold": 0.45, "min_silence_duration_ms": 30},
               {"threshold": 0.5, "max_speech_duration_s": 1.5}):
        assert psilero.get_speech_timestamps(wav, lambda _w: probs, **kw) == \
            jsilero.get_speech_timestamps(wav, lambda _w: probs, **kw)
    assert system_sad(_speechy(np.random.default_rng(seed), 6.0), vad_model=model) == \
        jsystem_sad(_speechy(np.random.default_rng(seed), 6.0), vad_model=PARAMS)


def test_npz_roundtrip_and_converters(tmp_path, model):
    path = str(tmp_path / "vad.npz")
    psilero.save_silero_params(path, PARAMS)
    loaded = psilero.load_silero_params(path)
    jloaded = jsilero.load_silero_params(path)
    sd = silero_state_from_jax(loaded)
    assert set(sd) == set(psilero.SileroVAD().state_dict())
    for k, v in silero_state_from_jax(jloaded).items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    wav = (np.random.default_rng(1).standard_normal(16000) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(psilero.silero_probs(psilero.SileroVAD.from_file(path), wav),
                                  psilero.silero_probs(model, wav))
    # the official state_dict layout, through both packages' converters
    official = {"_model.stft.forward_basis_buffer": PARAMS["stft_basis"][:, None, :]}
    for i in range(4):
        official[f"_model.encoder.{i}.reparam_conv.weight"] = PARAMS[f"encoder_{i}"]["kernel"]
        official[f"_model.encoder.{i}.reparam_conv.bias"] = PARAMS[f"encoder_{i}"]["bias"]
    for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        official[f"_model.decoder.rnn.{k}"] = torch.from_numpy(PARAMS["lstm"][k])
    official["_model.decoder.decoder.2.weight"] = PARAMS["out"]["kernel"]
    official["_model.decoder.decoder.2.bias"] = PARAMS["out"]["bias"]
    got = psilero.convert_silero_state_dict(official)
    want = jsilero.convert_silero_state_dict(official)
    for k, v in silero_state_from_jax(want).items():
        torch.testing.assert_close(silero_state_from_jax(got)[k], v, rtol=0, atol=0)
    a = psilero.silero_init_params(np.random.default_rng(9))
    b = jsilero.silero_init_params(np.random.default_rng(9))
    for k, v in silero_state_from_jax(b).items():
        torch.testing.assert_close(silero_state_from_jax(a)[k], v, rtol=0, atol=0)
