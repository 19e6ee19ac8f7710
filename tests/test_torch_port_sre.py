"""The port's NIST SRE drivers on the CPU: their back-end stages against the
JAX drivers (`examples/sre/v2/run.py`'s `backend_stage`, v3's stages 6-8,
loaded by path) on the same `.npz` sets, and the port's SRE v2 stages 2-7
and v3 stages 1-8 end to end at a tiny width on 8 kHz audio, with the
exported program through bin/infer_export against bin/extract.

Bars: score files within 2e-5 (the `%.5f` rounding) and EERs within 0.01
percentage points of the JAX drivers'; infer_export's embedding at cosine
>= 0.99999 with bin/extract's (float32 on the CPU).
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from wespeaker_hubert_tpu_torch.bin import infer_export
from wespeaker_hubert_tpu_torch.bin.extract import extract
from wespeaker_hubert_tpu_torch.data.wav_io import write_wav
from wespeaker_hubert_tpu_torch.recipes import sre_v2, sre_v3
from wespeaker_hubert_tpu_torch.utils.embeddings import load_embeddings, save_embeddings

ROOT = Path(__file__).resolve().parents[1]
SR = 8000
DIM = 16


def _jax_driver(version):
    spec = importlib.util.spec_from_file_location(
        f"jax_sre_{version}", ROOT / "examples" / "sre" / version / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _backend_sets(root: Path, seed=0):
    """Seeded embeddings with speaker structure: a 30-speaker PLDA training
    set, an in-domain set shifted in mean and spread, 10 enrollment models
    of 1-3 sessions, 24 test segments and every model x test trial."""
    rng = np.random.default_rng(seed)
    shift = rng.standard_normal(DIM)

    def draw(centres, n, domain=0.0):
        return (centres + rng.standard_normal((n, DIM))
                + domain * (shift + 0.5 * rng.standard_normal((n, DIM)))).astype(np.float32)

    centres = 2.0 * rng.standard_normal((30, DIM))
    spk = np.repeat(np.arange(30), 4)
    keys = [f"tr{s:02d}-{i:03d}" for i, s in enumerate(spk)]
    save_embeddings(str(root / "train.npz"), keys, draw(centres[spk], len(spk)))
    (root / "train.utt2spk").write_text("".join(f"{k} s{s}\n" for k, s in zip(keys, spk)))
    ev = 2.0 * rng.standard_normal((10, DIM))
    save_embeddings(str(root / "indomain.npz"), [f"in{i:03d}" for i in range(60)],
                    draw(ev[rng.integers(0, 10, 60)], 60, 1.0))
    sessions = [int(rng.integers(1, 4)) for _ in range(10)]
    e_spk = np.repeat(np.arange(10), sessions)
    e_keys = [f"en{i:03d}" for i in range(len(e_spk))]
    save_embeddings(str(root / "enroll.npz"), e_keys, draw(ev[e_spk], len(e_spk), 1.0))
    (root / "enroll.utt2spk").write_text("".join(f"{k} m{s}\n" for k, s in zip(e_keys, e_spk)))
    t_spk = rng.integers(0, 10, 24)
    t_keys = [f"te{i:03d}" for i in range(24)]
    save_embeddings(str(root / "test.npz"), t_keys, draw(ev[t_spk], 24, 1.0))
    (root / "trials").write_text("".join(
        f"m{m} {k} {'target' if m == s else 'nontarget'}\n"
        for m in range(10) for k, s in zip(t_keys, t_spk)))


def _scores(path):
    return [ln.split() for ln in Path(path).read_text().splitlines()]


def _assert_same_scores(got, want):
    g, w = _scores(got), _scores(want)
    assert [r[:2] + r[3:] for r in g] == [r[:2] + r[3:] for r in w]
    np.testing.assert_allclose([float(r[2]) for r in g], [float(r[2]) for r in w],
                               rtol=0, atol=2e-5)


def _eers(lines):
    return {ln.split(":")[0].strip(): float(ln.split("EER ")[1].split("%")[0])
            for ln in lines if "EER " in ln}


def test_backend_stages_match_jax_drivers(tmp_path, capsys, monkeypatch):
    _backend_sets(tmp_path)
    sets = [str(tmp_path / n) for n in ("train.npz", "train.utt2spk", "enroll.npz",
                                        "enroll.utt2spk", "test.npz", "trials")]
    # SRE v2: PLDA, multisession scoring, adaptation
    _jax_driver("v2").backend_stage(*sets, str(tmp_path / "jax_v2"),
                                    adapt_emb=str(tmp_path / "indomain.npz"), em_iters=3)
    jax_out = capsys.readouterr().out
    lines = sre_v2.backend_stage(*sets, str(tmp_path / "port_v2"),
                                 adapt_emb=str(tmp_path / "indomain.npz"), em_iters=3,
                                 device="cpu")
    for tag in ("plda", "plda_adapt"):
        _assert_same_scores(tmp_path / "port_v2" / f"{tag}.score",
                            tmp_path / "jax_v2" / f"{tag}.score")
    want = _eers(jax_out.splitlines())
    assert set(_eers(lines)) == set(want) == {"plda", "plda_adapt"}
    for k, v in _eers(lines).items():
        assert abs(v - want[k]) <= 0.01, (k, v, want[k])

    # SRE v3 stages 6-8: the chain, the in-domain mean, adaptation
    argv = ["--stage", "6", "--stop_stage", "8", "--train_emb", sets[0], "--train_utt2spk",
            sets[1], "--enroll_emb", sets[2], "--enroll_utt2spk", sets[3], "--test_emb",
            sets[4], "--trials", sets[5], "--indomain_emb", str(tmp_path / "indomain.npz"),
            "--lda_dim", "8", "--em_iters", "3"]
    monkeypatch.setattr(sys, "argv",
                        ["run.py"] + argv + ["--exp_dir", str(tmp_path / "jax_v3")])
    capsys.readouterr()
    _jax_driver("v3").main()
    jax_out = capsys.readouterr().out
    done = sre_v3.main(argv + ["--exp_dir", str(tmp_path / "port_v3"), "--device", "cpu"])
    tags = ("plda_ctsmean", "plda_indomainmean", "plda_adapt")
    for tag in tags:
        _assert_same_scores(tmp_path / "port_v3" / "scores" / f"{tag}.score",
                            tmp_path / "jax_v3" / "scores" / f"{tag}.score")
    got = _eers(sum((done[s]["lines"] for s in (6, 7, 8)), []))
    want = _eers(jax_out.splitlines())
    assert set(got) == set(want) == {f"{t}.score" for t in tags}
    for k, v in got.items():
        assert abs(v - want[k]) <= 0.01, (k, v, want[k])


def _voice(rng, f0, seconds):
    t = np.arange(int(seconds * SR)) / SR
    env = (np.sin(2 * np.pi * 0.7 * t) > -0.6).astype(np.float64)  # pauses for the VAD
    x = 0.2 * env * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.standard_normal(len(t))
    return x.astype(np.float32)


def _write_sre_data(data: Path, cts: Path):
    """8 kHz stand-ins of every set both drivers read: aug sources, the
    extractor and PLDA training sets (with a VAD file), the unlabeled
    in-domain set, enrollment, test and trials, and a CTS-superset key with
    its audio.  Each speaker is a tone at its own pitch."""
    rng = np.random.default_rng(1)

    def wav(path, x):
        path.parent.mkdir(parents=True, exist_ok=True)
        write_wav(str(path), x, SR)
        return str(path)

    for sub, key, n, length in (("musan", "noise", 2, 8000), ("rirs", "rir", 2, 400)):
        rows = []
        for i in range(n):
            x = rng.standard_normal(length) * (0.1 if sub == "musan"
                                               else np.exp(-np.arange(length) / 50))
            rows.append(f"{key}-{i} {wav(data / sub / f'{key}-{i}.wav', x.astype(np.float32))}")
        (data / sub / "wav.scp").write_text("\n".join(rows) + "\n")
    sets = {"swbd_sre": (4, 4, True), "sre": (4, 3, True), "sre16_major": (3, 2, False),
            "sre16_eval_enroll": (3, 2, True), "sre16_eval_test": (3, 2, False)}
    for dset, (n_spk, per, labeled) in sets.items():
        scp, u2s, vad = [], [], []
        for s in range(n_spk):
            for i in range(per):
                utt = f"{dset}-s{s}-{i}"
                seconds = 2.5 + 0.5 * ((s + i) % 3)
                x = _voice(rng, 150 + 60 * s, seconds)
                scp.append(f"{utt} {wav(data / dset / f'{utt}.wav', x)}")
                u2s.append(f"{utt} {'m' if dset.endswith('enroll') else 'spk'}{s}")
                vad.append(f"{utt}-0000 {utt} 0.000 {seconds - 0.2:.3f}")
        (data / dset / "wav.scp").write_text("\n".join(scp) + "\n")
        if labeled:
            (data / dset / "utt2spk").write_text("\n".join(u2s) + "\n")
        if dset in ("swbd_sre", "sre"):
            (data / dset / "vad").write_text("\n".join(vad) + "\n")
    tests = [ln.split()[0] for ln in (data / "sre16_eval_test" / "wav.scp").read_text().split("\n")
             if ln]
    (data / "trials").write_text("".join(
        f"m{m} {t} {'target' if t.split('-')[1] == f's{m}' else 'nontarget'}\n"
        for m in range(3) for t in tests))
    rows = ["segmentid\tsubjectid\tspeakerid"]
    for s in range(4):
        for i in range(2):
            seg = f"cts-s{s}-{i}"
            wav(cts / "data" / f"{seg}.wav", _voice(rng, 170 + 50 * s, 3.0))
            rows.append(f"{seg}.sph\t{s}\tcts{s}")
    (cts / "docs").mkdir(parents=True)
    (cts / "docs" / "cts_superset_segment_key.tsv").write_text("\n".join(rows) + "\n")


def test_sre_recipes_end_to_end_on_cpu(tmp_path, capsys):
    data, exp = tmp_path / "data", tmp_path / "exp"
    _write_sre_data(data, tmp_path / "cts")
    overrides = [
        f"exp_dir={exp}", f"train_data={data / 'swbd_sre' / 'shard.list'}",
        f"train_label={data / 'swbd_sre' / 'utt2spk'}",
        f"dataset_args.reverb_data={data / 'rirs_aug_store'}",
        f"dataset_args.noise_data={data / 'musan_aug_store'}",
        "dataset_args.resample_rate=8000", "dataset_args.num_frms=50",
        "dataset_args.fbank_args.num_mel_bins=16", "model_args.feat_dim=16",
        "model_args.embed_dim=8", "model=ResNet18", "model_args.m_channels=4",
        "dataloader_args.batch_size=8", "num_epochs=1", "epoch_iter=2", "num_avg=1",
        "log_batch_interval=1"]
    conf = str(ROOT / "examples/voxceleb/v2/conf/resnet34.yaml")
    trials = str(data / "trials")
    done = sre_v2.main(["--stage", "1", "--stop_stage", "7", "--config", conf, "--data_root",
                        str(data), "--trials", trials, "--out_dir", str(tmp_path / "v2_scores"),
                        "--em_iters", "2", "--device", "cpu"] + overrides)
    out = capsys.readouterr().out
    assert sorted(done) == list(range(1, 8))
    for tag in ("cosine", "plda", "plda_adapt"):
        assert f"{tag}: EER " in out and (tmp_path / "v2_scores" / f"{tag}.score").exists()
    assert len(_scores(tmp_path / "v2_scores" / "cosine.score")) == 3 * 6
    for dset in sre_v2.EVAL_SETS:
        assert (exp / "embeddings" / f"{dset}.npz").exists()
    exported = exp / "exported"
    assert sorted(os.listdir(exported)) == ["avg_model.pt", "config.json", "model.pt2"]
    assert json.loads((exported / "config.json").read_text())["dataset_args"][
        "resample_rate"] == 8000

    # the exported program on a wav of exactly one extraction bucket (200
    # frames: bin/extract pads nothing), against bin/extract
    wav_path = tmp_path / "one.wav"
    write_wav(str(wav_path), _voice(np.random.default_rng(2), 210, 16120 / SR), SR)
    (tmp_path / "one.list").write_text(json.dumps({"key": "one", "wav": str(wav_path),
                                                   "spk": "x"}) + "\n")
    config = sre_v2.apply_overrides(sre_v2.load_config(conf), overrides)
    _, want = extract(config, str(tmp_path / "one.list"), str(exp / "avg_model.pt"), None,
                      device="cpu")
    feats = infer_export.compute_fbank(str(wav_path), num_mel_bins=16, device="cpu")
    assert feats.shape == (1, 200, 16)
    got = infer_export.infer(str(exported / "model.pt2"), feats, device="cpu")
    cos = float(torch.nn.functional.cosine_similarity(torch.from_numpy(got),
                                                      torch.from_numpy(want)))
    assert cos >= 0.99999, cos

    # SRE v3 on the same data and config: stages 1-2, 4-8 (stage 3's
    # checkpoints are v2's, in the same exp_dir)
    emb = exp / "embeddings"
    common = ["--config", conf, "--data_root", str(data), "--cts_dir", str(tmp_path / "cts"),
              "--exp_dir", str(tmp_path / "v3"), "--dur_thres", "1.0",
              "--eval_sets", "sre16_major,sre16_eval_enroll,sre16_eval_test",
              "--enroll_emb", str(emb / "sre16_eval_enroll.npz"),
              "--enroll_utt2spk", str(data / "sre16_eval_enroll" / "utt2spk"),
              "--test_emb", str(emb / "sre16_eval_test.npz"), "--trials", trials,
              "--indomain_emb", str(emb / "sre16_major.npz"), "--lda_dim", "4",
              "--em_iters", "2", "--device", "cpu"]
    first = sre_v3.main(["--stage", "1", "--stop_stage", "2"] + common + overrides)
    rest = sre_v3.main(["--stage", "4", "--stop_stage", "8"] + common + overrides)
    out = capsys.readouterr().out
    assert sorted(first) == [1, 2] and sorted(rest) == [4, 5, 6, 7, 8]
    vad = (data / "cts" / "vad").read_text().splitlines()
    assert vad and all(len(ln.split()) == 4 for ln in vad)
    assert len((data / "cts_aug" / "wav.scp").read_text().splitlines()) == 3 * 8
    assert (exp / "export" / "avg_model.pt").exists()
    # bin/extract augments nothing: cts_aug's three copies are equal rows
    # (as in the JAX package; ROADMAP.md queue 3)
    keys, rows = load_embeddings(str(emb / "cts_aug.npz"))
    by_seg = {}
    for k, r in zip(keys, rows):
        by_seg.setdefault(k.rsplit("_copy-", 1)[0], []).append(r)
    assert len(by_seg) == 8 and all(len(v) == 3 and np.array_equal(v[0], v[1])
                                    and np.array_equal(v[0], v[2]) for v in by_seg.values())
    for tag in ("plda_ctsmean", "plda_indomainmean", "plda_adapt"):
        assert f"{tag}.score: EER " in out
        assert len(_scores(tmp_path / "v3" / "scores" / f"{tag}.score")) == 3 * 6
    with pytest.raises(ValueError, match="stages 6-8 need"):
        sre_v3.main(["--stage", "6", "--exp_dir", str(tmp_path / "none"), "--device", "cpu"])
