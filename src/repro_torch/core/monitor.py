"""The ``__schedule()`` shim: user-level stand-in for the paper's two kernel
instrumentation points.

The paper patches the kernel so that a *monitored* thread entering a real
block (not a preemption) increments its core's blocked counter, and
increments the unblocked counter on wake.  We cannot load a kernel patch
here, so every blocking operation the runtime performs goes through
``umt_blocking()`` which issues exactly those two eventfd writes around the
real OS call.  ``umt_thread_ctrl()`` is the thread opt-in, as in the paper.

The ``io`` namespace provides monitored versions of the blocking calls the
benchmarks use (file I/O, socket I/O, sleeps, waits).  Unmonitored threads
(or code outside a runtime) pass straight through — zero overhead, like the
paper's two-branch kernel fast path.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time as _time

_tls = threading.local()


def umt_thread_ctrl(worker):
    """Opt the current thread in (worker) or out (None) of monitoring."""
    _tls.worker = worker


def current_worker():
    return getattr(_tls, "worker", None)


@contextlib.contextmanager
def umt_blocking():
    """Wrap a genuinely-blocking operation with the paper's two events.

    Equivalent to the kernel checking ``state == TASK_RUNNING`` before
    ``__schedule()``: only true blocks are instrumented, never preemption
    (user level has no preemption to confuse us).
    """
    w = current_worker()
    if w is None:
        yield
        return
    if w.monitored:                 # UMT on: the kernel-side eventfd write
        w.block_channel().write_block()
    w.on_block()                    # tracing is mode-independent (honest
    try:                            # baseline CPU% needs idle visibility)
        yield
    finally:
        # unblock is reported on the core the thread wakes on (migration
        # compensation is handled by the worker when it is re-targeted).
        if w.monitored:
            w.unblock_channel().write_unblock()
        w.on_unblock()


class io:
    """Monitored blocking operations (the OS surface the runtime uses)."""

    @staticmethod
    def write(f, data):
        with umt_blocking():
            return f.write(data)

    @staticmethod
    def read(f, n=-1):
        with umt_blocking():
            return f.read(n)

    @staticmethod
    def pwrite(fd, data, off):
        with umt_blocking():
            return os.pwrite(fd, data, off)

    @staticmethod
    def pread(fd, n, off):
        with umt_blocking():
            return os.pread(fd, n, off)

    @staticmethod
    def fsync(f):
        with umt_blocking():
            return os.fsync(f.fileno() if hasattr(f, "fileno") else f)

    @staticmethod
    def sleep(sec):
        with umt_blocking():
            _time.sleep(sec)

    @staticmethod
    def sendall(sock, data):
        with umt_blocking():
            return sock.sendall(data)

    @staticmethod
    def recv(sock, n):
        with umt_blocking():
            return sock.recv(n)

    @staticmethod
    def recv_exact(sock, n):
        with umt_blocking():
            buf = bytearray()
            while len(buf) < n:
                chunk = sock.recv(n - len(buf))
                if not chunk:
                    raise ConnectionError("peer closed")
                buf += chunk
            return bytes(buf)

    @staticmethod
    def wait(event_or_cv, timeout=None):
        with umt_blocking():
            return event_or_cv.wait(timeout)

    @staticmethod
    def acquire(sem, timeout=None):
        # NOTE: the runtime's park() does NOT use this — parking needs
        # its block event pinned to the park-entry core (see
        # UMTRuntime.park), so it brackets the semaphore manually.
        with umt_blocking():
            return sem.acquire(timeout=timeout)

    @staticmethod
    def call(fn, *args, **kw):
        """Run an arbitrary blocking callable under monitoring."""
        with umt_blocking():
            return fn(*args, **kw)
