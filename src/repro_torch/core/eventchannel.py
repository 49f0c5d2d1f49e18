"""Per-core event channels — the paper's UMT kernel interface, verbatim.

Each core gets one **real** ``eventfd`` (paper §III-B).  The 64-bit counter
packs two 32-bit counts: low 32 bits = threads that *blocked* on this core,
high 32 bits = threads that *unblocked*, both since the last ``read()``.
``read()`` drains both counts atomically (eventfd semantics reset the
counter), exactly the downcall the paper advocates over SA-style upcalls.

Counter overflow (2^32 blocks without a read) is not handled — the paper
makes the same simplification (§III-B, footnote 4).
"""
from __future__ import annotations

import os

BLOCK_UNIT = 1
UNBLOCK_UNIT = 1 << 32
_MASK32 = (1 << 32) - 1


class EventChannel:
    """One core's eventfd, packed (blocked | unblocked<<32).

    ``writes`` counts kernel-side eventfd writes (stats only — used to
    compare the paper's design against the §V "idle-only" variant)."""

    __slots__ = ("core", "fd", "_closed", "writes", "_drained")

    def __init__(self, core: int):
        self.core = core
        self.fd = os.eventfd(0, os.EFD_NONBLOCK | os.EFD_CLOEXEC)
        self._closed = False
        self.writes = 0
        self._drained = 0     # `writes` watermark at the last read()

    # ---- kernel side (called from the scheduler shim) ----
    # The counter bump comes *after* the eventfd write: a reader that
    # snapshots `writes` concurrently can then only *under*-estimate, so
    # read_if_dirty() may delay a drain (until the bump lands or the
    # Leader's forced drain runs) but never lose one.
    def write_block(self):
        os.eventfd_write(self.fd, BLOCK_UNIT)
        self.writes += 1

    def write_unblock(self):
        os.eventfd_write(self.fd, UNBLOCK_UNIT)
        self.writes += 1

    # ---- user side (Leader Thread / worker scheduling points) ----
    def read(self) -> tuple[int, int]:
        """Drain -> (blocked, unblocked) since last read; (0,0) if empty."""
        seen = self.writes          # snapshot *before* the drain: a write
        try:                        # racing the read is either included in
            v = os.eventfd_read(self.fd)    # the value (extra no-op read
        except BlockingIOError:             # later) or still pending
            self._drained = seen            # (flag stays dirty)
            return (0, 0)
        self._drained = seen
        return (v & _MASK32, v >> 32)

    def read_if_dirty(self) -> tuple[int, int]:
        """Drain only when events may be pending.  The eventfd_read
        syscall releases the GIL, and re-acquiring it under load costs
        orders of magnitude more than this integer compare — skipping
        clean channels is what makes submissions and scheduling points
        O(1) and cheap.  The flag is racy by design; the Leader's forced
        epoll drain + 1 ms rescan (paper §III) is the correctness
        backstop, exactly as for the paper's racy counters."""
        if self.writes == self._drained:
            return (0, 0)
        return self.read()

    def fileno(self) -> int:
        return self.fd

    def close(self):
        if not self._closed:
            self._closed = True
            os.close(self.fd)

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def umt_enable(n_cores: int) -> list[EventChannel]:
    """The paper's ``umt_enable()`` syscall: one eventfd per core."""
    return [EventChannel(c) for c in range(n_cores)]
