"""Kaldi-style text table readers: wav.scp, utt2spk and trial files are
whitespace tables.  Counterpart of `wespeaker_hubert_tpu/utils/file_utils.py`.

  read_scp    -- 2-column 'key value' -> list[(key, value)]
  read_lists  -- one entry per line -> list[str]
  read_table  -- whitespace-split rows -> list[list[str]]
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = ["read_scp", "read_lists", "read_table"]


def read_scp(path: str) -> List[Tuple[str, str]]:
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, _, value = line.partition(" ")
            out.append((key, value.strip()))
    return out


def read_lists(path: str) -> List[str]:
    with open(path, "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def read_table(path: str) -> List[List[str]]:
    with open(path, "r", encoding="utf-8") as f:
        return [ln.split() for ln in f if ln.strip()]
