"""Port parity for the Speaker's diarization (wespeaker_hubert_tpu_torch/
cli/speaker.py) against the JAX package's, with shared weights, and the
port's surfaces over it: the server's /diarize and KServe `run`, the CLI's
diarization tasks, the VoxConverse recipes and the offline hub.

The model is ECAPA_TDNN_c512 at 80 mels with a 32-d embedding (the JAX
package's tests/test_diar_batch.py model), carried into the port by
`from_jax_variables`; the conversations are 6-11 s of alternating tones.
Window embeddings within 1e-4 relative of JAX's; diarized segments equal
to JAX's (the spectral path's up to a relabelling: its k-means is the
port's own); batched equal to sequential, exactly.  Two tests on purpose:
the file holds the one JAX Speaker compile."""

import functools
import json
import os
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_diar_batch import _conversation
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from wespeaker_hubert_tpu.bin.train import build_speaker_net as jax_build_speaker_net
from wespeaker_hubert_tpu.cli import speaker as jspeaker
from wespeaker_hubert_tpu.diar import spectral_cluster as jax_spectral_cluster
from wespeaker_hubert_tpu.diar.silero import save_silero_params, silero_init_params
from wespeaker_hubert_tpu.utils.checkpoint import save_checkpoint
from wespeaker_hubert_tpu.utils.config import dump_config
from wespeaker_hubert_tpu_torch.bin.serve import EmbeddingService, _make_handler
from wespeaker_hubert_tpu_torch.cli import hub as phub
from wespeaker_hubert_tpu_torch.cli import speaker as pspeaker
from wespeaker_hubert_tpu_torch.data.wav_io import write_wav
from wespeaker_hubert_tpu_torch.diar import spectral_cluster, write_rttm
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables
from wespeaker_hubert_tpu_torch.recipes import voxconverse_v1, voxconverse_v2

MODEL = "ECAPA_TDNN_c512"
CONFIG = {"model": MODEL, "model_args": {"feat_dim": 80, "embed_dim": 32},
          "dataset_args": {"fbank_args": {"num_mel_bins": 80}}}
SECONDS = (6.0, 11.0, 8.5)


def _pcm16(x):
    """Samples on the int16 grid: WAV files and JSON carry them exactly."""
    return (np.rint(np.clip(x, -1, 1) * 32767) / 32768.0).astype(np.float32)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("diarize")
    net = jax_build_speaker_net(CONFIG, num_class=2)
    variables = net.init(jax.random.key(0), jnp.zeros((1, 100, 80)),
                         jnp.zeros((1,), jnp.int32), 0.0, train=False)
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    jdir, pdir = root / "jax", root / "port"
    jdir.mkdir()
    pdir.mkdir()
    dump_config(CONFIG, str(jdir / "config.yaml"))
    save_checkpoint(str(jdir / "avg_model.ckpt"), variables)
    (pdir / "config.json").write_text(json.dumps(CONFIG))
    torch.save(from_jax_variables(MODEL, variables, feat_dim=80), pdir / "avg_model.pt")
    save_silero_params(str(pdir / "vad.npz"), silero_init_params(np.random.default_rng(3)))
    rng = np.random.default_rng(1)
    wavs = [_pcm16(_conversation(rng, s)) for s in SECONDS]
    return {"root": root, "jax": str(jdir), "port": str(pdir), "wavs": wavs}


def _relabelled(a, b):
    """Same segments, labels equal up to a bijection."""
    if [s[:3] for s in a] != [s[:3] for s in b]:
        return False
    pairs = {(x[3], y[3]) for x, y in zip(a, b)}
    return len(pairs) == len({p[0] for p in pairs}) == len({p[1] for p in pairs})


def test_diarize_matches_jax_and_batch_matches_sequential(dirs, monkeypatch):
    monkeypatch.setattr(jspeaker, "spectral_cluster",
                        functools.partial(jax_spectral_cluster, seed=7))
    monkeypatch.setattr(pspeaker, "spectral_cluster",
                        functools.partial(spectral_cluster, seed=7))
    js, ps = jspeaker.Speaker(dirs["jax"]), pspeaker.Speaker(dirs["port"], device="cpu")
    wavs, utts = dirs["wavs"], ["a", "b", "c"]

    segs = ps._vad_segments(wavs[1])
    assert segs == js._vad_segments(wavs[1])
    feats = ps._segment_fbanks(wavs[1], segs)
    windows = np.stack([np.resize(f[s: s + 150], (150, 80)) for f in feats
                        for s in range(0, max(len(f) - 75, 1), 75)])
    want = np.asarray(js._extract_embedding_feats(windows))
    got = ps._extract_embedding_feats(windows)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    for clusterer in ("spectral", "density"):
        jax_out = [js.diarize_pcm(w, utt=u, clusterer=clusterer) for w, u in zip(wavs, utts)]
        seq = [ps.diarize_pcm(w, utt=u, clusterer=clusterer) for w, u in zip(wavs, utts)]
        if clusterer == "density":
            assert seq == jax_out
        else:
            assert all(_relabelled(a, b) for a, b in zip(seq, jax_out))
        assert ps.diarize_pcm_batch(wavs, utts=utts, clusterer=clusterer) == seq
        assert set(ps.last_diar_timings) == {"vad", "fbank", "embed", "cluster"}

    # the pooled upload split in pools, and a segment past the limit refused
    pieces = [w[: n] for w, n in zip(wavs, (20000, 45000, 31000))]
    ref = ps._fbank_slices_device(pieces)
    monkeypatch.setattr(pspeaker, "_FLAT_SAMPLE_LIMIT", 70000)
    split = ps._fbank_slices_device(pieces)
    for (b0, r0, n0), (b1, r1, n1) in zip(ref[1], split[1]):
        assert n0 == n1
        torch.testing.assert_close(ref[0][b0][r0, :n0], split[0][b1][r1, :n1], rtol=0, atol=0)
    monkeypatch.setattr(pspeaker, "_FLAT_SAMPLE_LIMIT", 1000)
    with pytest.raises(ValueError, match="upload limit"):
        ps._fbank_slices_device([np.zeros(1001, np.float32)])
    monkeypatch.undo()

    # Silero VAD (the segment fbank sliced from the VAD's own batches), CMN
    # per segment, and a silent conversation
    ps.set_vad(True)
    assert ps.vad_model is not None
    ps.set_diarization_params(subseg_cmn=False)
    batch = [np.zeros(16000, np.float32)] + wavs
    assert ps.diarize_pcm_batch(batch, utts=["s"] + utts) == \
        [ps.diarize_pcm(w, utt=u) for w, u in zip(batch, ["s"] + utts)]
    with pytest.raises(ValueError, match="auto|host|device"):
        ps.set_diarization_params(cluster_impl="gpu")

    # audio at another rate is resampled as the JAX package resamples it
    path = str(dirs["root"] / "8k.wav")
    write_wav(path, wavs[0][::2], sample_rate=8000)
    np.testing.assert_array_equal(ps._load_audio(path), js._load_audio(path))


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _rttm_lines(path):
    with open(path) as f:
        return sorted(f.read().splitlines())


def test_served_cli_recipes_and_hub(dirs, monkeypatch, capsys):
    root, wavs = dirs["root"], dirs["wavs"][:2]
    service = EmbeddingService(dirs["port"], device="cpu", max_batch=2, max_seconds=2.0,
                               chunk_frames=50, bf16=False)
    service._diar_window = 0.5  # the two posts below land in one batch
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(service))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        direct = service.speaker.diarize_pcm_batch(wavs, utts=["unk", "unk"])
        assert direct == [service.speaker.diarize_pcm(w) for w in wavs]
        paths = [str(root / f"conv{i}.wav") for i in range(len(wavs))]
        for p, w in zip(paths, wavs):
            write_wav(p, w)
        results = [None] * len(wavs)

        def post(i):
            with open(paths[i], "rb") as f:
                results[i] = _post(url + "/diarize", f.read())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(wavs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
        for got, want in zip(results, direct):
            assert [(s["utt"], s["begin"], s["end"], s["speaker"])
                    for s in got["segments"]] == want
        body = {"inputs": [{"name": "input", "shape": [1, len(wavs[0])], "datatype": "FP32",
                            "data": wavs[0].tolist()}]}
        out = _post(url + "/v2/models/run/infer", json.dumps(body).encode())["outputs"][0]
        assert out["name"] == "LABELS" and out["shape"] == [len(direct[0]), 3]
        np.testing.assert_allclose(np.asarray(out["data"]).reshape(-1, 3),
                                   [[b, e, s] for _, b, e, s in direct[0]], rtol=1e-6)
        with urllib.request.urlopen(url + "/v2/models/diarization", timeout=30) as r:
            assert json.loads(r.read())["outputs"][0]["name"] == "LABELS"
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            assert json.loads(r.read())["diarization"]["total_steps"] == len(wavs) + 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
        t.join(timeout=10)
    assert not t.is_alive()

    # the CLI's diarization tasks and the v2 recipe write the same RTTM lines
    scp = root / "wav.scp"
    scp.write_text("".join(f"c{i} {p}\n" for i, p in enumerate(paths)))
    cli = ["-p", dirs["port"], "--device", "cpu"]
    pspeaker.main(["-t", "diarization_list", "--wav_scp", str(scp),
                   "--output_file", str(root / "list.rttm")] + cli)
    pspeaker.main(["-t", "diarization", "--audio_file", paths[0],
                   "--output_file", str(root / "one.rttm")] + cli)
    ref = {f"c{i}": [(b, e, f"spk{s}") for _, b, e, s in d] for i, d in enumerate(direct)}
    write_rttm(str(root / "ref.rttm"), [(u, b, e, s) for u, t in ref.items() for b, e, s in t])
    d = voxconverse_v2.main(["--model_dir", dirs["port"], "--wav_scp", str(scp),
                             "--out_rttm", str(root / "v2.rttm"), "--clusterer", "density",
                             "--ref_rttm", str(root / "ref.rttm"), "--device", "cpu"])
    assert _rttm_lines(root / "v2.rttm") == _rttm_lines(root / "list.rttm")
    assert _rttm_lines(root / "one.rttm") == [
        line.replace(" c0 ", " unk ") for line in _rttm_lines(root / "list.rttm") if " c0 " in line]
    assert d["der"] == 0.0 and "DER 0.00%" in capsys.readouterr().out
    # v1: oracle SAD from per-utterance reference RTTMs, and system SAD
    (root / "ref_dir").mkdir()
    for u, turns in ref.items():
        write_rttm(str(root / "ref_dir" / f"{u}.rttm"), [(u, b, e, s) for b, e, s in turns])
    for sad in ("oracle", "system"):
        d = voxconverse_v1.main(["--model_dir", dirs["port"], "--wav_scp", str(scp),
                                 "--sad_type", sad, "--ref_rttm_dir", str(root / "ref_dir"),
                                 "--out_rttm", str(root / f"v1_{sad}.rttm"), "--device", "cpu"])
        assert np.isfinite(d["der"])
    assert os.path.getsize(root / "v1_oracle.rttm") > 0

    # the hub: a registered alias, and a WeSpeaker bundle converted in place
    monkeypatch.setenv("WESPEAKER_TORCH_HUB", str(root / "hub"))
    with pytest.raises(ValueError, match="'english'"):
        pspeaker.load_model("english", device="cpu")
    phub.Hub.register("english", dirs["port"])
    assert phub.Hub.get_model("english") == dirs["port"]
    bundle = root / "hub" / "chinese"
    bundle.mkdir(parents=True)
    dump_config(CONFIG, str(bundle / "config.yaml"))
    sd = torch.load(os.path.join(dirs["port"], "avg_model.pt"), weights_only=True)
    torch.save({"model": {**sd, "projection.weight": torch.zeros(2, 32)}},
               bundle / "avg_model.pt")
    model = pspeaker.load_model("chinese", device="cpu")
    assert (bundle / "config.json").exists() and (bundle / phub.BUNDLE_CKPT).exists()
    np.testing.assert_array_equal(
        model.extract_embedding(paths[0]),
        pspeaker.load_model(dirs["port"], device="cpu").extract_embedding(paths[0]))
