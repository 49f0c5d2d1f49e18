"""Launch counters: one per kernel wrapper, bumped where the wrapper
launches its kernel and nowhere else, so a run can show that its main
path went through the kernel.  Serve tasks launch from several worker
threads, hence the lock."""
from __future__ import annotations

import threading


class LaunchCounter:
    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n
