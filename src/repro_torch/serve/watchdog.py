"""Drain a serve engine under a deadline.

``drain(eng, reqs, timeout_s)`` closes the engine's queue and waits for
each request, then for the engine's own tasks, all under one deadline,
and shuts the engine down.  A wait that passes the deadline fails loudly
instead of hanging its caller: ``TimeoutError`` carrying the engine's
``stats()`` and the stack of every thread (``faulthandler``), after the
engine's shutdown is started on a daemon thread (a wedged engine cannot
be joined; its workers are daemon threads too).

Works with the port's ``ServeEngine`` and, by duck typing, with the
reference's (``close``, ``join``, ``stats``, ``shutdown``, ``rt``).
"""
from __future__ import annotations

import faulthandler
import tempfile
import threading
import time


def abandon(eng, why: str, shutdown_s: float = 10.0):
    """Fail a wedged engine loudly: its stats and every thread's stack
    (as ``faulthandler`` writes them) in the error, its shutdown started
    on a daemon thread (joined for at most ``shutdown_s``)."""
    with tempfile.TemporaryFile("w+") as f:
        faulthandler.dump_traceback(file=f, all_threads=True)
        f.seek(0)
        stacks = f.read()
    try:
        stats = eng.stats()
    except Exception as e:              # noqa: BLE001 — reported below
        stats = f"stats() raised {e!r}"
    stopper = threading.Thread(target=eng.shutdown, daemon=True,
                               name="drain-shutdown")
    stopper.start()
    stopper.join(shutdown_s)
    raise TimeoutError(f"{why}\nengine stats: {stats}\n"
                       f"threads:\n{stacks}")


def drain(eng, reqs, timeout_s: float = 120.0) -> dict:
    """Close ``eng``'s queue, wait for every request of ``reqs`` and for
    the engine's tasks within ``timeout_s`` in all, then shut it down.
    Returns ``eng.stats()`` taken before the shutdown.  A request that
    failed inside the engine stays failed (``req.wait()`` re-raises)."""
    deadline = time.monotonic() + timeout_s
    eng.close()
    for r in reqs:
        if not r.done.wait(max(0.0, deadline - time.monotonic())):
            failed = [(q.rid, q.error) for q in reqs
                      if q.error is not None]
            abandon(eng, f"request {r.rid} not done after {timeout_s} s "
                         f"({len(r.out_tokens)} tokens out); failed "
                         f"requests: {failed}")
    if not eng.rt.wait_all(max(0.0, deadline - time.monotonic())):
        abandon(eng, f"engine tasks still running {timeout_s} s after "
                     "the drain began, every request done")
    eng.join()                          # quiet by now: re-raises a failure
    stats = eng.stats()
    eng.shutdown()
    return stats


__all__ = ["drain", "abandon"]
