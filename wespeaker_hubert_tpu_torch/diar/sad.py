"""Speech-activity detection inputs for diarization.

Counterpart of `wespeaker_hubert_tpu/diar/sad.py`: oracle SAD from a
reference RTTM with a minimum-duration filter (WeSpeaker's
make_oracle_sad.py), the energy VAD with hangover smoothing that stands in
when no Silero weights are at hand, and system SAD (make_system_sad.py:
Silero at threshold 0.18, segments shorter than min_duration dropped).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .der import _merge_intervals

__all__ = ["oracle_sad", "energy_vad", "system_sad"]


def oracle_sad(
    rttm_turns: Dict[str, List[Tuple[float, float, str]]],
    min_duration: float = 0.255,
) -> Dict[str, List[Tuple[float, float]]]:
    """Union of reference speaker turns -> speech segments, dropping
    segments shorter than min_duration."""
    out: Dict[str, List[Tuple[float, float]]] = {}
    for utt, turns in rttm_turns.items():
        merged = _merge_intervals([(b, e) for b, e, _ in turns])
        out[utt] = [(b, e) for b, e in merged if e - b >= min_duration]
    return out


def energy_vad(
    wav: np.ndarray,
    sample_rate: int = 16000,
    frame_ms: float = 30.0,
    threshold_db: float = -40.0,
    min_speech: float = 0.25,
    min_silence: float = 0.3,
) -> List[Tuple[float, float]]:
    """Frame-energy VAD with duration smoothing -> (begin_s, end_s) list."""
    frame = int(sample_rate * frame_ms / 1000)
    n = len(wav) // frame
    if n == 0:
        return []
    frames = wav[: n * frame].reshape(n, frame)
    db = 10 * np.log10(np.mean(frames**2, axis=1) + 1e-10)
    # adaptive floor: threshold relative to the loudest frames
    ref = np.percentile(db, 95)
    active = db > max(ref + threshold_db, -60.0)

    segs: List[List[float]] = []
    t = frame_ms / 1000.0
    for i, a in enumerate(active):
        if a:
            if segs and i * t - segs[-1][1] < min_silence:
                segs[-1][1] = (i + 1) * t
            else:
                segs.append([i * t, (i + 1) * t])
    return [(b, e) for b, e in segs if e - b >= min_speech]


def system_sad(
    wav: np.ndarray,
    sample_rate: int = 16000,
    vad_model: Optional[object] = None,
    min_duration: float = 0.255,
    threshold: float = 0.18,
) -> List[Tuple[float, float]]:
    """System SAD segments (begin_s, end_s): Silero at `threshold`,
    segments shorter than min_duration dropped.

    vad_model: a diar.silero.SileroVAD, a Silero parameter tree (loaded on
    the CPU), or any callable wav -> per-window probabilities.  None: the
    energy VAD."""
    if vad_model is None:
        return [
            (b, e)
            for b, e in energy_vad(wav, sample_rate)
            if e - b >= min_duration
        ]
    from .silero import SileroVAD, get_speech_timestamps

    model = vad_model if callable(vad_model) else SileroVAD.from_params(vad_model)
    ts = get_speech_timestamps(
        wav, model, threshold=threshold, sampling_rate=sample_rate
    )
    out = []
    for t in ts:
        b = t["start"] / sample_rate
        e = t["end"] / sample_rate
        if e - b >= min_duration:
            out.append((b, e))
    return out
