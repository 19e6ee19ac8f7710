"""Config parsing for the port's entry points.

Counterpart of `parse_config_or_kwargs` in
`wespeaker_hubert_tpu/utils/config.py`: a config is a dict, a `.json` file
or, where PyYAML imports, a `.yaml` / `.yml` file (the training config
schema either way); keyword overrides replace top-level keys.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Union

__all__ = ["load_config", "parse_config_or_kwargs"]


def load_config(path: str) -> Dict[str, Any]:
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError:
            raise RuntimeError(
                f"{path}: reading a YAML config needs PyYAML, which is not "
                "installed; pass the config as JSON"
            ) from None
        with open(path, "r", encoding="utf-8") as f:
            return yaml.safe_load(f) or {}
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def parse_config_or_kwargs(
    config: Union[str, Dict[str, Any]], **kwargs
) -> Dict[str, Any]:
    """A config dict or file, with keyword overrides of top-level keys."""
    out = copy.deepcopy(config) if isinstance(config, dict) else load_config(config)
    out.update(kwargs)
    return out
