"""The port's CN-Celeb v2 driver against the JAX driver
(`examples/cnceleb/v2/run.py`, loaded by path), on the CPU at a tiny size.

The port's `recipes.cnceleb_v2` runs stages 1-9 on `conf/resnet34.yaml`
(ResNet18 at 4 channels, 16 mels, batch 8; stage 3 on the C++ loader the
config's `num_workers: 8` asks for) with the VoxCeleb ResNet lm config for
stage 9; each run's stage-8 program against its eager model (stage 9's
program binds the fine-tuned weights to stage 8's trace).  The JAX driver
runs its stages 1-2 on a copy of the data (the lists and aug-store indexes
must be the port's byte for byte, the shards' members too) and its stages
5-7 on the port's stage-4 embeddings: the cosine, AS-Norm and QMF score files
of both trial lists (the concatenated and the averaged enrollments) within
the bars of tests/test_torch_port_score.py (cosine 1.1e-5, AS-Norm 2.1e-4,
QMF 1e-4: the Cllr fit's 1e-8 on parameters of size ~10 and one rounding
flip), and their EERs within 0.01 points.
"""

import argparse
import importlib.util
import json
import os
import shutil
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from wespeaker_hubert_tpu_torch.bin.export_model import load_program
from wespeaker_hubert_tpu_torch.data.wav_io import write_wav
from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net, load_speaker_state
from wespeaker_hubert_tpu_torch.recipes import cnceleb_v2

ROOT = Path(__file__).resolve().parents[1]
TRIALS = ("CNC-Eval-Concat.lst", "CNC-Eval-Avg.lst")
# per score-file kind: the bar of each numeric column
BARS = {".score": [1.1e-5], ".score.asnorm": [2.1e-4] + [1.1e-4] * 4, ".score.asnorm.qmf": [1e-4]}


def _jax_driver():
    spec = importlib.util.spec_from_file_location("jax_cnceleb_v2",
                                                  ROOT / "examples" / "cnceleb" / "v2" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_cnceleb_data(root: Path, n_spk: int = 4, per_spk: int = 4, seed: int = 0):
    """MUSAN / RIR stand-ins, `cnceleb_train` (n_spk x per_spk utterances of
    2.5-7 s, so both QMF duration pools fill), `eval` with one concatenated
    enrollment per speaker (`spkN-enroll`) and 2 test utterances each, and
    both trial lists under `eval/trials` (the averaged list over the first
    test utterance of each speaker)."""
    rng = np.random.default_rng(seed)

    def wav(path, x):
        path.parent.mkdir(parents=True, exist_ok=True)
        write_wav(str(path), x.astype(np.float32))
        return str(path)

    for sub, key, n, length in (("musan", "noise", 3, 8000), ("rirs", "rir", 2, 800)):
        lines = []
        for i in range(n):
            x = rng.standard_normal(length) * (0.1 if sub == "musan"
                                               else np.exp(-np.arange(length) / 100))
            lines.append(f"{key}-{i} {wav(root / sub / f'{key}-{i}.wav', x)}")
        (root / sub / "wav.scp").write_text("\n".join(lines) + "\n")

    def voice(spk, seconds):
        t = np.arange(int(seconds * 16000)) / 16000
        return (0.1 * np.sin(2 * np.pi * (180 + 70 * spk) * t)
                + 0.05 * rng.standard_normal(len(t)))

    sets = {"cnceleb_train": [(f"id1{s:04d}-{i:02d}", s, (2.5, 3.0, 6.5, 7.0)[i % 4])
                              for s in range(n_spk) for i in range(per_spk)],
            "eval": [(f"id0{s:04d}-enroll", s, 6.0) for s in range(n_spk)]
            + [(f"id0{s:04d}-test{i}", s, 2.0 + i) for s in range(n_spk) for i in range(2)]}
    for dset, utts in sets.items():
        (root / dset).mkdir(parents=True, exist_ok=True)
        (root / dset / "wav.scp").write_text("".join(
            f"{u} {wav(root / dset / f'{u}.wav', voice(s, secs))}\n" for u, s, secs in utts))
        (root / dset / "utt2spk").write_text("".join(f"{u} spk{s}\n" for u, s, _ in utts))
    tests = [(u, s) for u, s, _ in sets["eval"] if "test" in u]
    concat = [f"id0{e:04d}-enroll {u} {'target' if e == s else 'nontarget'}"
              for e in range(n_spk) for u, s in tests]
    (root / "eval" / "trials").mkdir()
    (root / "eval" / "trials" / TRIALS[0]).write_text("\n".join(concat) + "\n")
    (root / "eval" / "trials" / TRIALS[1]).write_text(
        "\n".join(t for t in concat if t.split()[1].endswith("test0")) + "\n")


def _members(shard):
    with tarfile.open(shard) as tf:
        return [(m.name, tf.extractfile(m).read()) for m in tf if m.isfile()]


def _columns(path):
    rows = [ln.split() for ln in open(path)]
    names = [(r[0], r[1], r[3] if len(r) > 3 else None) for r in rows]
    nums = np.asarray([[float(x) for i, x in enumerate(r) if i >= 2 and i != 3] for r in rows])
    return names, nums


def _eers(text):
    return {ln.split(":")[0]: float(ln.split("EER ")[1].split("%")[0])
            for ln in text.splitlines() if ": EER " in ln}


def test_driver_stages_1_to_9_match_jax_driver(tmp_path, capsys):
    data = tmp_path / "data"
    write_cnceleb_data(data)
    shutil.copytree(data, tmp_path / "jax_data")
    paths = [f"train_data={data / 'cnceleb_train' / 'shard.list'}",
             f"train_label={data / 'cnceleb_train' / 'utt2spk'}",
             f"dataset_args.reverb_data={data / 'rirs_aug_store'}",
             f"dataset_args.noise_data={data / 'musan_aug_store'}"]
    tiny = ["num_epochs=1", "epoch_iter=1", "num_avg=1", "log_batch_interval=1", "model=ResNet18",
            "model_args.m_channels=4", "dataloader_args.batch_size=8", "model_args.feat_dim=16",
            "dataset_args.fbank_args.num_mel_bins=16", "model_args.embed_dim=8"]
    argv = (["--stage", "1", "--stop_stage", "9", "--config",
             str(ROOT / "examples/cnceleb/v2/conf/resnet34.yaml"), "--lm_config",
             str(ROOT / "examples/voxceleb/v2/conf/resnet_lm.yaml"), "--data_root", str(data),
             "--calibration_trial_num", "20", "--device", "cpu",
             f"exp_dir={tmp_path / 'exp'}", "dataset_args.num_frms=50"] + paths + tiny
            + [f"lm.exp_dir={tmp_path / 'exp_lm'}", "lm.dataset_args.num_frms=60"]
            + ["lm." + o for o in paths + tiny])
    done = cnceleb_v2.main(argv)
    out = capsys.readouterr().out
    assert sorted(done) == list(range(1, 10)) and sorted(done[9]["stages"]) == list(range(3, 9))
    # each run's stage-8 program (stage 9's binds its weights to stage 8's
    # trace) against its eager model
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 77, 16)).astype(
        np.float32))
    outs = []
    for exp in ("exp", "exp_lm"):
        exported = tmp_path / exp / "exported"
        net = build_speaker_net(json.loads((exported / "config.json").read_text()))
        load_speaker_state(net, torch.load(exported / "avg_model.pt", weights_only=True))
        with torch.no_grad():
            outs.append(load_program(str(exported / "model.pt2"))(feats))
            np.testing.assert_allclose(outs[-1].numpy(), net.eval().embed(feats).numpy(),
                                       rtol=0, atol=1e-5, err_msg=exp)
        for trial in TRIALS:
            assert f"{trial}.score.asnorm.qmf: EER " in out
    assert not torch.allclose(outs[0], outs[1], atol=1e-3)
    # stage 9's checks come before stage 1
    with pytest.raises(SystemExit):
        cnceleb_v2.main(["--stage", "1", "--stop_stage", "9", "--data_root", str(data)])
    assert "stage 1" not in capsys.readouterr().out

    jax_run = _jax_driver()
    jax_data, jax_exp = tmp_path / "jax_data", tmp_path / "jax_exp"
    args = argparse.Namespace(data_root=str(jax_data), trials=list(TRIALS), asnorm_top_n=300,
                              calibration_trial_num=20)
    jax_run.run_stages(args, {"exp_dir": str(jax_exp)}, 1, 2)
    for rel in ("cnceleb_train/raw.list", "eval/raw.list", "musan_aug_store/index.json",
                "rirs_aug_store/index.json"):
        got, want = (data / rel).read_text(), (jax_data / rel).read_text()
        assert got == want.replace(str(jax_data), str(data)), rel
    shards = [(data / "cnceleb_train" / "shard.list").read_text(),
              (jax_data / "cnceleb_train" / "shard.list").read_text()]
    assert shards[0] == shards[1].replace(str(jax_data), str(data))
    assert [_members(p) for p in shards[0].split()] == [_members(p) for p in shards[1].split()]

    capsys.readouterr()
    port_exp = tmp_path / "exp"
    shutil.copytree(port_exp / "embeddings", jax_exp / "embeddings",
                    ignore=shutil.ignore_patterns("*_mean*"))
    args.data_root = str(data)
    jax_run.run_stages(args, {"exp_dir": str(jax_exp)}, 5, 7)
    jax_out = capsys.readouterr().out
    port_lines = sum((done[s]["lines"] for s in (5, 6, 7)), [])
    want_eers = _eers(jax_out)
    assert set(_eers("\n".join(port_lines))) == set(want_eers) and len(want_eers) == 6
    for name, eer in _eers("\n".join(port_lines)).items():
        assert abs(eer - want_eers[name]) <= 0.01, name
    for trial in TRIALS:
        for suffix, bars in BARS.items():
            got, want = (_columns(port_exp / "scores" / (trial + suffix)),
                         _columns(jax_exp / "scores" / (trial + suffix)))
            assert got[0] == want[0] and got[1].shape == want[1].shape
            for col, bar in enumerate(bars):
                np.testing.assert_allclose(got[1][:, col], want[1][:, col], rtol=0, atol=bar,
                                           err_msg=f"{trial}{suffix} column {col}")
    assert os.path.exists(jax_exp / "calibration.trials")
