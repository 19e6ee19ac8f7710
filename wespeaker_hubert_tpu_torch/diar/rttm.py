"""RTTM IO and subsegment-label merging.

Counterpart of `wespeaker_hubert_tpu/diar/rttm.py` (numpy and the standard
library only, copied): WeSpeaker's diar/make_rttm.py (read_labels,
merge_segments, the RTTM line) and make_oracle_sad.py (RTTM -> segments).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

from .subsegment import parse_subseg_id

__all__ = [
    "read_labels_file",
    "merge_segments",
    "write_rttm",
    "read_rttm",
]

Segment = Tuple[str, float, float, str]  # (utt, begin, end, label)


def read_labels_file(path: str, frame_shift: int = 10) -> "OrderedDict[str, list]":
    """subseg-label file -> utt -> [(begin_s, end_s, label)]."""
    utt_to_subseg_labels: "OrderedDict[str, list]" = OrderedDict()
    with open(path) as f:
        for line in f:
            subseg, label = line.strip().split()
            utt, begin, end = parse_subseg_id(subseg, frame_shift)
            utt_to_subseg_labels.setdefault(utt, []).append(
                (begin, end, label)
            )
    return utt_to_subseg_labels


def merge_segments(
    utt_to_subseg_labels: Dict[str, List[Tuple[float, float, str]]]
) -> List[Segment]:
    """Merge contiguous same-label subsegments; split conflicts at the
    midpoint (reference make_rttm.py:47-70)."""
    merged: List[Segment] = []
    for utt, subseg_to_labels in utt_to_subseg_labels.items():
        if not subseg_to_labels:
            continue
        begin, end, label = subseg_to_labels[0]
        e = end
        for (b, e, la) in subseg_to_labels[1:]:
            if b <= end and la == label:
                end = e
            elif b > end:
                merged.append((utt, begin, end, label))
                begin, end, label = b, e, la
            elif b <= end and la != label:
                pivot = (b + end) / 2.0
                merged.append((utt, begin, pivot, label))
                begin, end, label = pivot, e, la
            else:
                raise ValueError((b, e, la, begin, end, label))
        merged.append((utt, begin, e, label))
    return merged


def write_rttm(path: str, segments: List[Segment], channel: int = 1) -> None:
    spec = "SPEAKER {} {} {:.3f} {:.3f} <NA> <NA> {} <NA> <NA>\n"
    with open(path, "w") as f:
        for utt, begin, end, label in segments:
            f.write(spec.format(utt, channel, begin, end - begin, label))


def read_rttm(path: str) -> Dict[str, List[Tuple[float, float, str]]]:
    """RTTM -> utt -> [(begin, end, speaker)]."""
    out: Dict[str, List[Tuple[float, float, str]]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "SPEAKER":
                continue
            utt, begin, dur, spk = parts[1], float(parts[3]), float(parts[4]), parts[7]
            out.setdefault(utt, []).append((begin, begin + dur, spk))
    for segs in out.values():
        segs.sort()
    return out
