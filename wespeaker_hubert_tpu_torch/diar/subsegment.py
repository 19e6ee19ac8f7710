"""Sliding-window subsegmentation of SAD segments for diarization.

Counterpart of `wespeaker_hubert_tpu/diar/subsegment.py` (numpy only,
copied): frame-domain windows of 1.5 s every 0.75 s, short segments and
tails tile-padded by `np.resize` (WeSpeaker's diar/extract_emb.py), and the
seg-id convention `utt-beginms-endms-beginfrm-endfrm` make_rttm.py parses.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = [
    "subsegment_fbank",
    "subsegment_windows",
    "make_seg_id",
    "parse_subseg_id",
]


def make_seg_id(utt: str, begin_ms: int, end_ms: int) -> str:
    return f"{utt}-{begin_ms:08d}-{end_ms:08d}"


def parse_subseg_id(subseg: str, frame_shift: int = 10):
    """subseg id -> (utt, begin_s, end_s) (reference make_rttm.py:33-41)."""
    utt, begin_ms, end_ms, begin_frames, end_frames = subseg.rsplit("-", 4)
    begin = (int(begin_ms) + int(begin_frames) * frame_shift) / 1000.0
    end = (int(begin_ms) + int(end_frames) * frame_shift) / 1000.0
    return utt, begin, end


def subsegment_windows(
    seg_id: str,
    num_frames: int,
    window_fs: int = 150,
    period_fs: int = 75,
    frame_shift: int = 10,
) -> Tuple[List[str], List[Tuple[int, int]]]:
    """Window TABLE for one SAD segment: (subseg ids, [(start, m)]).

    `m` is the number of valid frames the window reads starting at
    `start`; np.resize tile semantics mean window row r holds frame
    `start + (r mod m)` (m == 0 -> all-zero window).  This is the shared
    source of truth for `subsegment_fbank` (host materialization) and
    the device-gather path (cli/speaker._embed_windows_device).
    """
    subsegs, table = [], []
    seg_begin, seg_end = seg_id.rsplit("-", 2)[-2:]
    seg_length = (int(seg_end) - int(seg_begin)) // frame_shift

    if seg_length <= window_fs:
        subsegs.append(seg_id + f"-{0:08d}-{seg_length:08d}")
        table.append((0, num_frames))
    else:
        max_subseg_begin = seg_length - window_fs + period_fs
        for subseg_begin in range(0, max_subseg_begin, period_fs):
            subseg_end = min(subseg_begin + window_fs, seg_length)
            subsegs.append(
                seg_id + f"-{subseg_begin:08d}-{subseg_end:08d}"
            )
            m = max(0, min(subseg_end, num_frames) - subseg_begin)
            table.append((subseg_begin, m))
    return subsegs, table


def subsegment_fbank(
    fbank: np.ndarray,
    seg_id: str,
    window_fs: int = 150,
    period_fs: int = 75,
    frame_shift: int = 10,
) -> Tuple[List[str], List[np.ndarray]]:
    """Cut one SAD segment's fbank into fixed 1.5 s windows.

    `seg_id` is `utt-beginms-endms`; the nominal segment length in frames
    comes from the id (reference extract_emb.py:59-64 — kaldi fbank yields
    seg_length-2 frames, the id-based length is used for window math).
    Short segments/tails are np.resize tile-padded to window_fs.
    """
    num_frames, feat_dim = fbank.shape
    subsegs, table = subsegment_windows(
        seg_id, num_frames, window_fs, period_fs, frame_shift
    )
    subseg_fbanks = [
        np.resize(fbank[start : start + m], (window_fs, feat_dim))
        for start, m in table
    ]
    return subsegs, subseg_fbanks
