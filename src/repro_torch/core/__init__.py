"""UMT — User-Monitored Threads (the paper's contribution).

A user-level, protocol-faithful implementation of the UMT Linux kernel
extension (eventfd block/unblock channels, Leader Thread, oversubscription
self-surrender) plus the Nanos6-style task runtime it drives.  See
DESIGN.md §1-2 and the fidelity ledger in §6.
"""
from .eventchannel import EventChannel, umt_enable
from .monitor import current_worker, io, umt_blocking, umt_thread_ctrl
from .runtime import Leader, UMTRuntime, Worker
from .task import (AtomicCounter, DependencyTracker, ReadyQueue,
                   ShardedReadyQueue, Task)
from .topology import detect_topology
from .tracing import Tracer

__all__ = [
    "EventChannel", "umt_enable", "current_worker", "io", "umt_blocking",
    "umt_thread_ctrl", "Leader", "UMTRuntime", "Worker", "AtomicCounter",
    "DependencyTracker", "ReadyQueue", "ShardedReadyQueue", "Task", "Tracer",
    "detect_topology",
]
