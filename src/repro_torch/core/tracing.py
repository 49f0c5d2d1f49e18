"""LTTng-style event tracer for the UMT runtime (paper §IV-A uses LTTng +
Babeltrace + Trace Compass; we record the same state transitions in-process
and derive the same metrics: per-core utilisation, oversubscription
periods, context-switch counts).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict


class Tracer:
    def __init__(self, enabled=True):
        self.enabled = enabled
        self.events: list[tuple] = []
        self._lock = threading.Lock()
        self.t0 = time.monotonic()

    def ev(self, kind: str, wid: int, core: int, info=None):
        if not self.enabled:
            return
        t = time.monotonic() - self.t0
        with self._lock:
            self.events.append((t, kind, wid, core, info))

    # ------------------------------------------------------------- analysis
    def core_timelines(self):
        """Per-core runnable-worker-count timeline: [(t, count), ...]."""
        deltas = defaultdict(list)
        for t, kind, wid, core, _ in sorted(self.events):
            if kind in ("spawn", "wake", "unblock"):
                deltas[core].append((t, +1))
            elif kind in ("park", "block"):
                deltas[core].append((t, -1))
        out = {}
        for core, ds in deltas.items():
            count = 0
            tl = []
            for t, d in ds:
                count += d
                tl.append((t, count))
            out[core] = tl
        return out

    def stats(self, n_cores: int, t_end: float | None = None) -> dict:
        """Fractions of wall-time each core spent busy (>=1 runnable
        worker) and oversubscribed (>=2), plus context-switch counts."""
        if t_end is None:
            t_end = max((e[0] for e in self.events), default=0.0)
        tls = self.core_timelines()
        busy = {}
        oversub = {}
        for core in range(n_cores):
            tl = tls.get(core, [])
            b = o = 0.0
            prev_t, prev_c = 0.0, 0
            for t, c in tl:
                dt = t - prev_t
                if prev_c >= 1:
                    b += dt
                if prev_c >= 2:
                    o += dt
                prev_t, prev_c = t, c
            dt = max(0.0, t_end - prev_t)
            if prev_c >= 1:
                b += dt
            if prev_c >= 2:
                o += dt
            busy[core] = b / t_end if t_end > 0 else 0.0
            oversub[core] = o / t_end if t_end > 0 else 0.0
        switches = steals = 0
        for e in self.events:
            if e[1] == "block":
                switches += 1
            elif e[1] == "steal":
                steals += 1
        return {
            "makespan_s": t_end,
            "cpu_util": sum(busy.values()) / max(n_cores, 1),
            "oversub_frac": sum(oversub.values()) / max(n_cores, 1),
            "ctx_switches": switches,
            "traced_steals": steals,
            "n_events": len(self.events),
            "per_core_busy": busy,
        }
