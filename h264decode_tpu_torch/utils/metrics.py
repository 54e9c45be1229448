"""Decode observability: per-stage counters and timers (SURVEY.md section 5).

The reference's only instrumentation is wall-of-text debug logging
(h264/server.go:21-27, bit_reader.go:322); this replaces it with structured
counters (NALs/s, MBs/s, frames/s) and per-stage wall-clock histograms that
the CLI prints as a summary (and can emit as JSON for scraping).
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager


class DecodeMetrics:
    def __init__(self):
        self.counters = defaultdict(int)
        self.timers = defaultdict(float)
        self.timer_calls = defaultdict(int)
        self._t0 = time.time()

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    @contextmanager
    def timer(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.add_time(name, time.time() - t0)

    def add_time(self, name: str, seconds: float):
        """One call of timer `name` that took `seconds`."""
        self.timers[name] += seconds
        self.timer_calls[name] += 1

    def summary(self) -> dict:
        wall = time.time() - self._t0
        out = {"wall_s": round(wall, 3)}
        for k, v in sorted(self.counters.items()):
            out[k] = v
            if wall > 0:
                out[f"{k}_per_s"] = round(v / wall, 2)
        for k, v in sorted(self.timers.items()):
            out[f"t_{k}_s"] = round(v, 3)
            out[f"t_{k}_calls"] = self.timer_calls[k]
        return out

    def dump(self) -> str:
        return json.dumps(self.summary(), indent=2)


GLOBAL = DecodeMetrics()
