"""Straggler detection over per-host step durations.

At pod scale a single slow host stalls every collective; the detector
flags hosts whose rolling step time exceeds ``factor`` x the fleet median
for ``patience`` consecutive steps.  Mitigations wired elsewhere: data
fetch re-issue (data.UMTPrefetcher), checkpoint-and-remesh (ft.elastic)
when a flagged host persists.
"""
from __future__ import annotations

import collections
import statistics


class StragglerDetector:
    def __init__(self, n_hosts: int, factor: float = 2.0, window: int = 8,
                 patience: int = 3):
        self.factor = factor
        self.patience = patience
        self.times = [collections.deque(maxlen=window)
                      for _ in range(n_hosts)]
        self.strikes = [0] * n_hosts

    def record(self, host: int, step_time: float):
        self.times[host].append(step_time)

    def _rolling(self, host: int) -> float | None:
        t = self.times[host]
        return statistics.median(t) if t else None

    def check(self) -> list[int]:
        """Returns hosts currently flagged as stragglers."""
        rolls = [self._rolling(h) for h in range(len(self.times))]
        valid = [r for r in rolls if r is not None]
        if len(valid) < 2:
            return []
        med = statistics.median(valid)
        flagged = []
        for h, r in enumerate(rolls):
            if r is not None and r > self.factor * med:
                self.strikes[h] += 1
            else:
                self.strikes[h] = 0
            if self.strikes[h] >= self.patience:
                flagged.append(h)
        return flagged
