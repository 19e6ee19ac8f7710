"""The port's WavLM staged recipe (recipes/voxceleb_v2_wavlm.py) against
the JAX package's driver, examples/voxceleb/v2/run_wavlm.py.

- Both drivers run on ecapa_tdnn_wavlm_frozen.yaml with bin/train and
  bin/average_model replaced by recorders: the port hands bin/train the
  same three configs as JAX's driver, and averages the same directories
  with the same counts, up to the checkpoint suffix (`.pt` for `.ckpt`).
- A tiny chain on the CPU (`s3prl_args.upstream: tiny`, raw wavs, one step
  per stage, stage 1 from a seeded `model_init`): every `frontend.upstream`
  tensor leaves stage 1 bitwise as it came in (the featurizer weights
  train, as JAX's optimizer mask leaves them); stage 2's and stage 3's
  models start from the previous stage's `avg_model.pt`, every tensor, but
  stage 3's head, which starts fresh at N classes (no speed perturbation)
  where stages 1-2 had 3 x N."""

import copy
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.test_torch_port_train import _store_arrays, _write_list
from wespeaker_hubert_tpu_torch.bin import train as bin_train
from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net, speaker_state_dict
from wespeaker_hubert_tpu_torch.recipes import voxceleb_v2_wavlm

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "examples/voxceleb/v2/conf/ecapa_tdnn_wavlm_frozen.yaml"


def _suffix(x):
    """A config or an argument with JAX's `.ckpt` paths as the port's `.pt`."""
    if isinstance(x, dict):
        return {k: _suffix(v) for k, v in x.items()}
    if isinstance(x, str) and x.endswith(".ckpt"):
        return x[: -len(".ckpt")] + ".pt"
    return x


def test_driver_hands_train_the_jax_configs(tmp_path, monkeypatch):
    conf = tmp_path / "frozen.yaml"  # the stage counts set, as a user would
    conf.write_text(CONFIG.read_text() + "joint_epochs: 4\nlmft_epochs: 2\n")
    spec = importlib.util.spec_from_file_location("run_wavlm",
                                                  ROOT / "examples/voxceleb/v2/run_wavlm.py")
    jax_driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_driver)
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jax_driver, "train", lambda cfg: calls["jax"].append(
        ("train", copy.deepcopy(cfg))))
    monkeypatch.setattr(jax_driver, "average_model", lambda src, dst, num: calls["jax"].append(
        ("average", src, dst, num)))
    monkeypatch.setattr(sys, "argv", ["run_wavlm.py", "--config", str(conf)])
    jax_driver.main()
    monkeypatch.setattr(voxceleb_v2_wavlm, "train", lambda cfg, device: calls["port"].append(
        ("train", copy.deepcopy(cfg))))
    monkeypatch.setattr(voxceleb_v2_wavlm, "average_model", lambda src, dst, num: calls[
        "port"].append(("average", src, dst, num)))
    done = voxceleb_v2_wavlm.main(["--config", str(conf), "--device", "cpu"])
    assert sorted(done) == [1, 2, 3]
    assert [c[0] for c in calls["jax"]] == ["train", "average"] * 3
    assert calls["port"] == [tuple(_suffix(x) for x in c) for c in calls["jax"]]
    trains = [c[1] for c in calls["port"] if c[0] == "train"]
    assert [c["exp_dir"].rsplit("-", 1)[-1] for c in trains] == ["frozen", "joint", "lmft"]
    assert [c["num_epochs"] for c in trains] == [60, 4, 2]
    assert [c["dataset_args"]["num_frms"] for c in trains] == [300, 300, 600]
    assert [c[3] for c in calls["port"] if c[0] == "average"] == [3, 2, 1]


def test_tiny_chain_on_cpu(tmp_path, monkeypatch, capsys):
    lines, labels = _write_list(str(tmp_path), n=8, seed=41)
    (tmp_path / "train.list").write_text("\n".join(lines) + "\n")
    (tmp_path / "utt2spk").write_text("\n".join(labels) + "\n")
    rirs, noises = _store_arrays(42)
    for name, arrays in (("rirs", rirs), ("musan", noises)):
        d = tmp_path / name
        d.mkdir()
        for key, x in arrays.items():
            np.save(d / f"{key}.npy", x)
        (d / "index.json").write_text(json.dumps({k: f"{k}.npy" for k in arrays}))
    overrides = [
        f"exp_dir={tmp_path}/exp", "data_type=raw", f"train_data={tmp_path}/train.list",
        f"train_label={tmp_path}/utt2spk", f"dataset_args.reverb_data={tmp_path}/rirs",
        f"dataset_args.noise_data={tmp_path}/musan", "dataset_args.s3prl_args.upstream=tiny",
        "dataset_args.filter_args.min_num_frames=50", "dataloader_args.batch_size=2",
        "dataset_args.num_frms=40", "num_epochs=1", "epoch_iter=1", "save_epoch_interval=1",
        "joint_epochs=1", "lmft_epochs=1", f"model_init={tmp_path}/init.pt"]
    base = voxceleb_v2_wavlm.apply_overrides(voxceleb_v2_wavlm.load_config(str(CONFIG)),
                                             overrides)
    torch.manual_seed(3)
    torch.save(speaker_state_dict(build_speaker_net(base, 9)), tmp_path / "init.pt")
    # each stage's model as its train step is made (after model_init)
    started = []
    make = bin_train.make_train_step

    def spy(model, *args, **kwargs):
        started.append({k: v.detach().clone() for k, v in speaker_state_dict(model).items()})
        return make(model, *args, **kwargs)

    monkeypatch.setattr(bin_train, "make_train_step", spy)
    done = voxceleb_v2_wavlm.main(["--config", str(CONFIG), "--device", "cpu"] + overrides)
    printed = capsys.readouterr().out
    assert [ln for ln in printed.splitlines() if ln.startswith("stage ")] == [
        v[1] for v in voxceleb_v2_wavlm.STAGES.values()]
    assert sorted(done) == [1, 2, 3] and len(started) == 3
    exp = f"{tmp_path}/exp"
    assert [done[s]["exp_dir"] for s in (1, 2, 3)] == [f"{exp}-frozen", f"{exp}-joint",
                                                       f"{exp}-joint-lmft"]
    avg = {s: torch.load(done[s]["avg_model"], weights_only=True) for s in (1, 2, 3)}
    init = torch.load(tmp_path / "init.pt", weights_only=True)
    # stage 1: the frozen encoder bitwise, from model_init to the average
    upstream = [k for k in init if k.startswith("frontend.upstream.")]
    assert upstream and all(torch.equal(started[0][k], init[k]) for k in init)
    assert all(torch.equal(avg[1][k], init[k]) for k in upstream)
    assert not torch.equal(avg[1]["frontend.featurizer_weights"],
                           init["frontend.featurizer_weights"])
    # stages 2 and 3 start from the previous stage's average
    assert set(started[1]) == set(avg[1])
    assert all(torch.equal(started[1][k], avg[1][k]) for k in avg[1])
    assert avg[2]["projection.weight"].shape[0] == 9  # 3 speakers x 3 speeds
    head = "projection.weight"
    assert all(torch.equal(started[2][k], avg[2][k]) for k in avg[2] if k != head)
    assert started[2][head].shape[0] == 3  # no speed perturbation: 3 classes
    torch.manual_seed(base["seed"])
    fresh = build_speaker_net(voxceleb_v2_wavlm.stage_configs(base)[3], 3)
    assert torch.equal(started[2][head], fresh.projection.weight.detach())
    # the frontend trains in stage 3
    assert any(not torch.equal(avg[3][k], avg[2][k]) for k in upstream)
