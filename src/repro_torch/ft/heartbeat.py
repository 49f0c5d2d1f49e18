"""Host liveness: heartbeat files + failure detection.

Each host process touches ``<dir>/host_<id>.hb`` every interval (a UMT
task — the write must never stall the training loop).  The monitor (run by
host 0 / an external supervisor) declares hosts dead after ``timeout``
and emits a remesh plan (see elastic.py).
"""
from __future__ import annotations

import os
import time


class HeartbeatMonitor:
    def __init__(self, dirpath: str, n_hosts: int, timeout: float = 5.0):
        self.dir = dirpath
        self.n_hosts = n_hosts
        self.timeout = timeout
        os.makedirs(dirpath, exist_ok=True)

    def path(self, host: int) -> str:
        return os.path.join(self.dir, f"host_{host:04d}.hb")

    # ---- host side ----
    def beat(self, host: int):
        p = self.path(host)
        with open(p, "w") as f:
            f.write(str(time.time()))

    def beat_task(self, rt, host: int):
        """Submit the heartbeat as a UMT task (never blocks the step)."""
        rt.submit(self.beat, host, name=f"hb{host}")

    # ---- monitor side ----
    def alive(self) -> list[int]:
        now = time.time()
        out = []
        for h in range(self.n_hosts):
            try:
                with open(self.path(h)) as f:
                    t = float(f.read().strip() or 0)
            except (OSError, ValueError):
                continue
            if now - t <= self.timeout:
                out.append(h)
        return out

    def dead(self) -> list[int]:
        a = set(self.alive())
        return [h for h in range(self.n_hosts) if h not in a]
