"""Throughput accounting and the metrics stream: copies of
`ThroughputMeter` and `MetricsLogger` from
`wespeaker_hubert_tpu/utils/observability.py`."""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict

__all__ = ["MetricsLogger", "ThroughputMeter"]


class ThroughputMeter:
    """Windowed throughput: call update(audio_seconds, steps) per batch."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events = deque(maxlen=window)
        self._total_audio = 0.0
        self._total_steps = 0
        self._start = time.perf_counter()
        self._last = self._start

    def update(self, audio_seconds: float, steps: int = 1):
        now = time.perf_counter()
        self._events.append((now - self._last, audio_seconds, steps))
        self._last = now
        self._total_audio += audio_seconds
        self._total_steps += steps

    @property
    def audio_seconds_per_s(self) -> float:
        dt = sum(e[0] for e in self._events)
        audio = sum(e[1] for e in self._events)
        return audio / dt if dt > 0 else 0.0

    @property
    def steps_per_s(self) -> float:
        dt = sum(e[0] for e in self._events)
        steps = sum(e[2] for e in self._events)
        return steps / dt if dt > 0 else 0.0

    @property
    def rtf(self) -> float:
        """Real-time factor (processing_time / audio_time)."""
        tput = self.audio_seconds_per_s
        return 1.0 / tput if tput > 0 else float("inf")

    def totals(self) -> Dict[str, float]:
        wall = time.perf_counter() - self._start
        return {
            "total_audio_seconds": self._total_audio,
            "total_steps": self._total_steps,
            "wall_seconds": wall,
            "avg_audio_seconds_per_s": self._total_audio / max(wall, 1e-9),
        }


class MetricsLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()
