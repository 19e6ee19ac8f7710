"""The port's host loaders against the JAX package's, on the CPU.

- `NativeTrainPipeline` (the C++ loader, built at first use) against JAX's:
  every batch bit for bit (`assert_array_equal` on every key), on a raw
  list and on tar shards, epochs 0 and 1, 1 and 4 threads, rank 0 of 1 and
  rank 1 of 2, with speed perturbation and packed augmentation; the raw
  list's batches are the same for 1 and 4 threads;
- `PrefetchPipeline` against JAX's on a config the C++ loader refuses;
- bin/train's choice of loader (`make_train_pipeline`) against the JAX
  package's for each condition the C++ loader refuses, and for those it
  takes;
- a failed build of the C++ loader raises, with the compiler's output;
- a 16 kHz wav under `resample_rate: 8000` is refused by TrainPipeline,
  EvalPipeline and the C++ loader (raw and shards), and an 8 kHz one by
  SSLPipeline (16 kHz), each naming the key and both rates;
- the library's build is keyed by the source's hash and reused, and the
  C++ loader's rows are crops of the wavs the Python reader reads, the
  same for the same seed.
"""

import hashlib
import json

import numpy as np
import pytest

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.test_torch_port_train import _store_arrays
from wespeaker_hubert_tpu.data import AugStore as JaxAugStore
from wespeaker_hubert_tpu.data import NativeTrainPipeline as JaxNativeTrainPipeline
from wespeaker_hubert_tpu.data import PrefetchPipeline as JaxPrefetchPipeline
from wespeaker_hubert_tpu.data import TrainPipelineConfig as JaxPipelineConfig
from wespeaker_hubert_tpu.data import native_loader as jax_native_loader
from wespeaker_hubert_tpu_torch.bin import tools
from wespeaker_hubert_tpu_torch.bin.train import make_train_pipeline
from wespeaker_hubert_tpu_torch.data import native_loader
from wespeaker_hubert_tpu_torch.data.aug_store import AugStore
from wespeaker_hubert_tpu_torch.data.dataset import (
    EvalPipeline,
    NativeTrainPipeline,
    PrefetchPipeline,
    TrainPipeline,
    TrainPipelineConfig,
)
from wespeaker_hubert_tpu_torch.data.wav_io import WavRateError, read_wav, write_wav
from wespeaker_hubert_tpu_torch.ssl.dataset import SSLPipeline

SPK2ID = {f"s{i}": i for i in range(4)}
# speed perturbation, packed reverb / noise rows, 0.5-2 s utterances
KW = dict(num_frms=30, shuffle_size=5, filter_min_frames=50, filter_max_frames=200,
          aug_prob=0.6, rir_max_samples=400, batch_size=4, seed=7)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """48 utterances of 0.6-1.9 s over 4 speakers (every 8th 0.35 s, under
    the length filter; the last 2 of an unknown speaker) as a raw list and
    as 16 tar shards of 3."""
    root = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(0)
    scp, u2s, lines = [], [], []
    for i in range(48):
        key, spk = f"u{i:02d}", (f"s{i % 4}" if i < 46 else "nobody")
        path = str(root / f"{key}.wav")
        seconds = 0.35 if i % 8 == 7 else rng.uniform(0.6, 1.9)
        write_wav(path, (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32))
        scp.append(f"{key} {path}")
        u2s.append(f"{key} {spk}")
        lines.append(json.dumps({"key": key, "wav": path, "spk": spk}))
    (root / "wav.scp").write_text("\n".join(scp) + "\n")
    (root / "utt2spk").write_text("\n".join(u2s) + "\n")
    tools.make_shard_list(str(root / "wav.scp"), str(root / "utt2spk"), str(root / "shards"),
                          str(root / "shard.list"), num_utts_per_shard=3, num_workers=1)
    shards = (root / "shard.list").read_text().split()
    return {"root": root, "raw": lines, "shard": shards, "stores": _store_arrays()}


def _pair(corpus, data_type, **kw):
    rirs, noises = corpus["stores"]
    cfg = dict(KW, data_type=data_type, **kw)
    return (cfg, (AugStore(arrays=rirs), AugStore(arrays=noises)),
            (JaxAugStore(arrays=rirs), JaxAugStore(arrays=noises)))


def _assert_same_batches(got, want, what):
    assert len(got) == len(want) > 0, what
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), what
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} batch {i} {k}")


@pytest.mark.parametrize("data_type", ["raw", "shard"])
def test_native_batches_match_jax(corpus, data_type):
    cfg, (rev, noise), (jrev, jnoise) = _pair(corpus, data_type)
    data = corpus[data_type]
    one_thread = {}
    for threads in (1, 4):
        for rank, world in ((0, 1), (1, 2)):
            got_pipe = NativeTrainPipeline(data, SPK2ID, TrainPipelineConfig(**cfg), rev, noise,
                                           rank=rank, world_size=world, num_threads=threads)
            want_pipe = JaxNativeTrainPipeline(data, SPK2ID, JaxPipelineConfig(**cfg), jrev,
                                               jnoise, rank=rank, world_size=world,
                                               num_threads=threads)
            for epoch in (0, 1):
                got_pipe.set_epoch(epoch)
                want_pipe.set_epoch(epoch)
                got = list(got_pipe)
                _assert_same_batches(got, list(want_pipe),
                                     f"{data_type} threads {threads} rank {rank}/{world} "
                                     f"epoch {epoch}")
                assert got[0]["rir"].shape[0] == 1 and got[0]["noise"].shape[0] == 1
                if data_type == "raw" and rank == 0:
                    if threads == 1:
                        one_thread[epoch] = got
                    else:  # the emission order is the thread count's no matter
                        _assert_same_batches(got, one_thread.get(epoch, []), "1 vs 4 threads")
            got_pipe.close()
            want_pipe.close()


def test_prefetch_matches_jax(corpus):
    """A keep-last config (the C++ loader drops the last batch): 3 workers'
    stripes, round-robin, epochs 0 and 1."""
    cfg, (rev, noise), (jrev, jnoise) = _pair(corpus, "raw", drop_last=False)
    got_pipe = PrefetchPipeline(corpus["raw"], SPK2ID, TrainPipelineConfig(**cfg), rev, noise,
                                num_workers=3, prefetch=2)
    want_pipe = JaxPrefetchPipeline(corpus["raw"], SPK2ID, JaxPipelineConfig(**cfg), jrev,
                                    jnoise, num_workers=3, prefetch=2)
    for epoch in (0, 1):
        got_pipe.set_epoch(epoch)
        want_pipe.set_epoch(epoch)
        _assert_same_batches(list(got_pipe), list(want_pipe), f"epoch {epoch}")


def _jax_choice(data, cfg, stores):
    """What the JAX package's bin/train runs for num_workers > 0: its C++
    pipeline, or PrefetchPipeline where that raises."""
    try:
        JaxNativeTrainPipeline(data, SPK2ID, JaxPipelineConfig(**cfg), *stores,
                               num_threads=2).close()
        return "NativeTrainPipeline"
    except Exception:
        return "PrefetchPipeline"


def test_loader_choice_matches_jax(corpus, monkeypatch):
    root = corpus["root"]
    (root / "x.xz").write_bytes(b"\xfd7zXZ\x00" + bytes(64))
    (root / "x.zst").write_bytes(b"\x28\xb5\x2f\xfd" + bytes(64))
    vad = json.loads(corpus["raw"][0]) | {"vad": [[0.0, 0.4]]}
    cases = {  # name -> (data, config changes, with stores)
        "raw": (corpus["raw"], {}, True),
        "shard": (corpus["shard"], {"data_type": "shard"}, True),
        "feat": (corpus["raw"], {"data_type": "feat"}, False),
        "unpacked_aug": (corpus["raw"], {"packed_aug": False}, True),
        "unpacked_no_stores": (corpus["raw"], {"packed_aug": False}, False),
        "unshuffled": (corpus["raw"], {"shuffle": False}, True),
        "keep_last": (corpus["raw"], {"drop_last": False}, True),
        "vad": (corpus["raw"][1:] + [json.dumps(vad)], {}, True),
        "xz": (corpus["shard"] + [str(root / "x.xz")], {"data_type": "shard"}, True),
        "zstd_without_zstd": (corpus["shard"] + [str(root / "x.zst")], {"data_type": "shard"},
                              True),
    }
    monkeypatch.setattr(native_loader, "native_zstd_available", lambda: False)
    monkeypatch.setattr(jax_native_loader, "native_zstd_available", lambda: False)
    rirs, noises = corpus["stores"]
    for name, (data, changes, with_stores) in cases.items():
        cfg = dict(KW, **changes)
        stores = ((AugStore(arrays=rirs), AugStore(arrays=noises)) if with_stores
                  else (None, None))
        jstores = ((JaxAugStore(arrays=rirs), JaxAugStore(arrays=noises)) if with_stores
                   else (None, None))
        pipe = make_train_pipeline(data, SPK2ID, TrainPipelineConfig(**cfg), *stores,
                                   {"num_workers": 2})
        assert type(pipe).__name__ == _jax_choice(data, cfg, jstores), name
        assert (name in ("raw", "shard", "unpacked_no_stores")) == isinstance(
            pipe, NativeTrainPipeline), name
    pipe = make_train_pipeline(corpus["raw"], SPK2ID, TrainPipelineConfig(**KW), None, None, {})
    assert type(pipe) is TrainPipeline


def test_failed_build_raises(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "_LIB", None)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="building the C\\+\\+ host loader failed") as err:
        make_train_pipeline(corpus["raw"], SPK2ID, TrainPipelineConfig(**KW), None, None,
                            {"num_workers": 2})
    assert "no-such-compiler" in str(err.value)
    assert not list((tmp_path / "native").iterdir())  # no half-written library left


def test_wav_at_another_rate_is_refused(corpus, tmp_path):
    root = corpus["root"]
    lines = [json.dumps({"key": f"e{i}", "wav": str(root / f"u{i:02d}.wav"), "spk": "s0"})
             for i in range(6)]  # 16 kHz wavs
    cfg = dict(KW, sample_rate=8000, filter_min_frames=10, filter_max_frames=2000)
    msg = r"(u\d\d|e\d): the wav's rate is 16000 Hz, but resample_rate is 8000"
    with pytest.raises(WavRateError, match=msg):
        list(TrainPipeline(lines, SPK2ID, TrainPipelineConfig(**cfg)))
    with pytest.raises(WavRateError, match=msg):
        list(EvalPipeline(lines, sample_rate=8000))
    for data_type, data in (("raw", lines), ("shard", corpus["shard"])):
        with pytest.raises(WavRateError, match=msg):
            list(NativeTrainPipeline(data, SPK2ID, TrainPipelineConfig(**cfg, data_type=data_type),
                                     num_threads=2))
        with pytest.raises(WavRateError, match=msg):
            list(TrainPipeline(data, SPK2ID, TrainPipelineConfig(**cfg, data_type=data_type)))
    # at their own rate the same wavs pass, and an 8 kHz wav is refused at 16 kHz
    assert sum(len(b["keys"]) for b in EvalPipeline(lines)) == 6
    path = str(tmp_path / "narrow.wav")
    write_wav(path, np.zeros(16000, np.float32), 8000)
    narrow = [json.dumps({"key": "narrow", "wav": path, "spk": "s0"})]
    with pytest.raises(WavRateError, match="narrow: the wav's rate is 8000 Hz, but "
                                           "resample_rate is 16000"):
        list(SSLPipeline(narrow, min_frames=10))


def test_native_build_and_crops(corpus):
    built = native_loader.build_native_library()
    digest = hashlib.sha256(native_loader.SOURCE.read_bytes()).hexdigest()[:16]
    assert built == native_loader.BUILD_DIR / f"libloader-{digest}.so"
    assert native_loader.build_native_library() == built  # reused, not rebuilt
    paths = [json.loads(ln)["wav"] for ln in corpus["raw"][:8]]
    wavs = [read_wav(p)[0] for p in paths]

    def batches(seed):
        loader = native_loader.DeterministicNativeLoader(
            paths, list(range(8)), chunk_samples=4000, batch_size=4, min_samples=1000,
            seed=seed, num_threads=2)
        out = list(loader.epoch(0))
        loader.close()
        return out

    got = batches(3)
    assert len(got) == 2 and sorted(np.concatenate([lab for _, lab, _ in got])) == list(range(8))
    for wav, label, speed in got:
        assert not speed.any()
        for row, lab in zip(wav, label):  # a crop of its own wav, sample for sample
            src = wavs[lab]
            starts = np.flatnonzero(src[: len(src) - 3999] == row[0])
            assert any(np.array_equal(src[s: s + 4000], row) for s in starts), lab
    for (w0, l0, _), (w1, l1, _) in zip(got, batches(3)):
        np.testing.assert_array_equal(w0, w1)
        np.testing.assert_array_equal(l0, l1)
