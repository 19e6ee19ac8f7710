"""Offline pretrained-model hub: alias -> local model directory.

Counterpart of `wespeaker_hubert_tpu/cli/hub.py` (WeSpeaker's cli/hub.py
maps an alias such as 'chinese' or 'english' to `~/.wespeaker/<alias>` and
downloads the published tar when the directory is missing).  Nothing is
downloaded here: an alias resolves to a local directory only,

  1. through an `aliases.json` registry ({alias: model_dir}) in the hub
     root, `$WESPEAKER_TORCH_HUB` or `~/.wespeaker_torch`
     (`Hub.register(alias, dir)` writes it);
  2. otherwise `<hub_root>/<alias>/` itself.

An alias that resolves to neither raises, naming it.  A resolved directory
is a model directory of the port (`config.json` + `avg_model.pt`, as
cli/speaker.py reads it).  One that holds only a published WeSpeaker
bundle (`config.yaml` + `avg_model.pt`) is converted in place by
`ensure_native_checkpoint`: the checkpoint is checked against the port's
module by bin/import_torch.py (strict: every key and shape) and written as
`avg_model.pt` (the bundle's file is kept as `wespeaker_avg_model.pt`), and
the config as `config.json`.
"""

from __future__ import annotations

import json
import logging
import os

__all__ = ["Hub", "ensure_native_checkpoint", "hub_root"]

logger = logging.getLogger("hub")

# WeSpeaker's published aliases (cli/hub.py's asset table)
KNOWN_ALIASES = (
    "chinese",   # cnceleb_resnet34
    "english",   # voxceleb_resnet221_LM
    "campplus",  # campplus_cn_common_200k
    "eres2net",  # eres2net_cn_commom_200k
    "vblinkp",   # voxblink2_samresnet34
    "vblinkf",   # voxblink2_samresnet34_ft
)
BUNDLE_CKPT = "wespeaker_avg_model.pt"


def hub_root() -> str:
    return os.environ.get(
        "WESPEAKER_TORCH_HUB", os.path.join(os.path.expanduser("~"), ".wespeaker_torch")
    )


def ensure_native_checkpoint(model_dir: str) -> str:
    """Make `model_dir` a model directory of the port, converting a
    WeSpeaker bundle (`config.yaml` + `avg_model.pt`) if that is what it
    holds.  Returns model_dir."""
    cfg_json = os.path.join(model_dir, "config.json")
    pt = os.path.join(model_dir, "avg_model.pt")
    if os.path.exists(cfg_json) and os.path.exists(pt):
        return model_dir
    cfg_yaml = os.path.join(model_dir, "config.yaml")
    if os.path.exists(cfg_yaml) and os.path.exists(pt):
        from ..bin.import_torch import import_torch
        from ..utils.config import load_config

        config = load_config(cfg_yaml)
        bundle = os.path.join(model_dir, BUNDLE_CKPT)
        os.replace(pt, bundle)
        logger.info("converting %s -> avg_model.pt (%s)", bundle, config["model"])
        try:
            import_torch(config["model"], bundle, pt, **dict(config.get("model_args", {})))
        except Exception:
            os.replace(bundle, pt)  # the bundle as it was
            raise
        tmp = f"{cfg_json}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(config, f, indent=1)
        os.replace(tmp, cfg_json)
        return model_dir
    raise FileNotFoundError(
        f"{model_dir!r} holds neither config.json + avg_model.pt nor a WeSpeaker "
        "config.yaml + avg_model.pt bundle"
    )


class Hub:
    """Alias resolution to local directories."""

    @staticmethod
    def register(alias: str, model_dir: str) -> None:
        """Persist alias -> directory in the hub registry."""
        root = hub_root()
        os.makedirs(root, exist_ok=True)
        reg_path = os.path.join(root, "aliases.json")
        reg = {}
        if os.path.exists(reg_path):
            with open(reg_path) as f:
                reg = json.load(f)
        reg[alias] = os.path.abspath(model_dir)
        tmp = f"{reg_path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(reg, f, indent=2, sort_keys=True)
        os.replace(tmp, reg_path)

    @staticmethod
    def get_model(alias: str) -> str:
        root = hub_root()
        reg_path = os.path.join(root, "aliases.json")
        if os.path.exists(reg_path):
            with open(reg_path) as f:
                reg = json.load(f)
            if alias in reg:
                return ensure_native_checkpoint(reg[alias])
        cand = os.path.join(root, alias)
        if os.path.isdir(cand):
            return ensure_native_checkpoint(cand)
        known = (" (a WeSpeaker alias: place its published bundle there)"
                 if alias in KNOWN_ALIASES else "")
        raise ValueError(
            f"unknown model alias {alias!r}{known}: no entry in {reg_path} and no "
            f"directory {cand}. Nothing is downloaded: copy a model directory "
            f"(config.json + avg_model.pt, or a WeSpeaker config.yaml + avg_model.pt, "
            f"which is converted) into the hub root ({root}) or register one with "
            "wespeaker_hubert_tpu_torch.cli.hub.Hub.register(alias, dir)."
        )
