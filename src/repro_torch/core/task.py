"""Nanos6-style task model: tasks with in/out data dependencies, nesting,
taskwait — the scheduling-point surface UMT hooks into.

Dependency semantics (OmpSs-2 subset): ``in_``/``out`` are hashable keys.
A reader depends on the last writer of each key; a writer depends on the
last writer *and* every reader since (WAR+WAW), i.e. the standard
serialisation of data accesses.
"""
from __future__ import annotations

import collections
import itertools
import threading

_ids = itertools.count()


class Task:
    __slots__ = ("tid", "fn", "args", "kwargs", "name", "in_", "out",
                 "pending", "succs", "parent", "children_left",
                 "child_done_ev", "done_ev", "result", "exc", "state")

    def __init__(self, fn, args, kwargs, in_, out, name, parent):
        self.tid = next(_ids)
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = name or getattr(fn, "__name__", "task")
        self.in_ = tuple(in_)
        self.out = tuple(out)
        self.pending = 0           # unfinished predecessors
        self.succs = []
        self.parent = parent
        self.children_left = 0
        self.child_done_ev = threading.Event()
        self.child_done_ev.set()
        self.done_ev = threading.Event()
        self.result = None
        self.exc = None
        self.state = "created"

    def wait(self):
        """Block until the task completes (monitored if inside a worker)."""
        from .monitor import io
        io.wait(self.done_ev)
        if self.exc is not None:
            raise self.exc
        return self.result

    def __repr__(self):
        return f"<Task {self.tid} {self.name} {self.state}>"


class DependencyTracker:
    """Per-key last-writer / readers-since-write bookkeeping."""

    def __init__(self):
        self._last_writer: dict = {}
        self._readers: dict = collections.defaultdict(list)
        self.lock = threading.Lock()

    def register(self, task: Task) -> int:
        """Wire `task` into the graph; returns #unfinished predecessors."""
        preds = set()
        with self.lock:
            for k in task.in_:
                w = self._last_writer.get(k)
                if w is not None and not w.done_ev.is_set():
                    preds.add(w)
                self._readers[k].append(task)
            for k in task.out:
                w = self._last_writer.get(k)
                if w is not None and not w.done_ev.is_set():
                    preds.add(w)
                for r in self._readers[k]:
                    if r is not task and not r.done_ev.is_set():
                        preds.add(r)
                self._readers[k] = []
                self._last_writer[k] = task
            n = 0
            for p in preds:
                # re-check under p's publication through scheduler lock:
                p.succs.append(task)
                n += 1
            task.pending = n
        return n


class AtomicCounter:
    """Small atomic integer: writers serialise on a private lock (CPython
    has no fetch-and-add), readers load ``.value`` directly — an attribute
    read is a single bytecode, so it never contends and never blocks.

    The read is *approximate* under concurrency (it may lag a concurrent
    add by one), which is exactly the contract the scheduler needs: idle
    checks and ``len(ready)`` tolerate staleness, the Leader's periodic
    rescan (paper §III) corrects any transient misread.
    """

    __slots__ = ("value", "_lock")

    def __init__(self, value: int = 0):
        self.value = value
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> int:
        with self._lock:
            self.value += n
            return self.value

    def __repr__(self):
        return f"AtomicCounter({self.value})"


class ReadyQueue:
    """Global FIFO ready queue — the pre-sharding scheduler, kept as the
    ``sched="global"`` option so benchmarks can measure the sharded fast
    path against it (see benchmarks/sched.py)."""

    def __init__(self):
        self._q = collections.deque()
        self.lock = threading.Lock()

    def push(self, task: Task):
        with self.lock:
            task.state = "ready"
            self._q.append(task)

    def push_front(self, task: Task):
        with self.lock:
            task.state = "ready"
            self._q.appendleft(task)

    def pop(self):
        with self.lock:
            if self._q:
                t = self._q.popleft()
                t.state = "claimed"
                return t
        return None

    def __len__(self):
        with self.lock:
            return len(self._q)


class ShardedReadyQueue:
    """Per-core ready deques with work stealing — the scheduler fast path.

    Shape follows the scx/sched_ext per-CPU dispatch queues: a producer
    pushes to one shard (its own core for cache affinity), a consumer pops
    its local shard FIFO, and only when the local deque is dry does it walk
    the other shards and steal their *oldest* task (head steal keeps every
    shard's FIFO order intact and globally approximates the old single
    queue).  Each shard has its own lock, so same-core push/pop never
    contends with other cores; ``len()`` reads an approximate
    ``AtomicCounter`` and takes no lock at all.

    Batch stealing: when the imbalance is large — the thief is dry while
    the victim holds at least ``steal_half_min`` tasks — the steal takes
    *half* the victim's deque (oldest half, order preserved) instead of
    one task: the extra tasks land at the head of the thief's local shard,
    so a burst fanned out on one core spreads in O(log) steals instead of
    one steal per task (scx-style load balancing).  Counted by
    ``steal_batches`` / ``steal_batch_tasks`` (surfaced in runtime
    stats).

    Topology-aware steal order: with ``topology`` set to an
    (n_shards, n_shards) distance matrix (``topology[i][j]`` = cost of
    shard ``i`` stealing from shard ``j`` — cache/NUMA distance on a real
    machine), each shard walks its victims nearest-*distance*-first, so a
    steal prefers an SMT sibling or same-socket core before crossing an
    interconnect (scx-style ``SCX_DSQ`` distance ordering).  Ties (and
    the ``topology=None`` default) fall back to the nearest-*index* ring
    walk, which keeps the pre-topology behaviour bit-for-bit.
    """

    def __init__(self, n_shards: int, steal_half_min: int = 4,
                 topology=None):
        assert n_shards >= 1
        assert steal_half_min >= 2
        self.n_shards = n_shards
        self.steal_half_min = steal_half_min
        # one precomputed victim walk per thief shard; the steal hot path
        # only ever indexes it
        self._steal_order = tuple(
            self._victim_walk(s, topology) for s in range(n_shards))
        self._qs = [collections.deque() for _ in range(n_shards)]
        self._locks = [threading.Lock() for _ in range(n_shards)]
        self._approx_len = AtomicCounter()
        self._rr = AtomicCounter()
        self.steals = AtomicCounter()
        self.steal_batches = AtomicCounter()      # steals that took > 1
        self.steal_batch_tasks = AtomicCounter()  # extra tasks re-homed

    def _victim_walk(self, shard: int, topology) -> tuple:
        """Victim visit order for ``shard``: every other shard, sorted by
        (distance, ring offset).  ``topology=None`` degenerates to the
        ring walk ``shard+1, shard+2, ... (mod n)`` exactly."""
        ring = [(shard + i) % self.n_shards
                for i in range(1, self.n_shards)]
        if topology is None:
            return tuple(ring)
        row = topology[shard]
        assert len(row) >= self.n_shards, (
            f"topology row {shard} covers {len(row)} shards, "
            f"need {self.n_shards}")
        return tuple(sorted(ring, key=lambda v: (row[v], ring.index(v))))

    def select_shard(self) -> int:
        """Round-robin home shard for external (non-worker) producers."""
        return self._rr.add(1) % self.n_shards

    def push(self, task: Task, shard: int):
        with self._locks[shard]:
            task.state = "ready"
            self._qs[shard].append(task)
        self._approx_len.add(1)

    def push_front(self, task: Task, shard: int):
        with self._locks[shard]:
            task.state = "ready"
            self._qs[shard].appendleft(task)
        self._approx_len.add(1)

    def pop_local(self, shard: int):
        """Pop the oldest local task, or None. Lock-free empty fast path:
        peeking an empty deque is safe under the GIL."""
        if not self._qs[shard]:
            return None
        with self._locks[shard]:
            if self._qs[shard]:
                t = self._qs[shard].popleft()
                t.state = "claimed"
                self._approx_len.add(-1)
                return t
        return None

    def steal(self, shard: int):
        """Walk the other shards (nearest neighbour first — by topology
        distance when one was given, ring index otherwise) and steal from
        the first non-empty one -> (task, victim) or (None, -1).

        The oldest task is claimed and returned; when the victim still
        holds ``steal_half_min - 1`` or more after that (large
        imbalance: the thief was dry), the steal also re-homes the next
        ``(victim_len // 2) - 1`` oldest tasks onto the thief's shard —
        half the victim's load moves in one locked pass, FIFO order
        preserved on both sides."""
        for victim in self._steal_order[shard]:
            if not self._qs[victim]:
                continue
            moved = ()
            with self._locks[victim]:
                vq = self._qs[victim]
                if not vq:
                    continue
                t = vq.popleft()
                t.state = "claimed"
                n = len(vq) + 1                     # victim load incl. t
                if n >= self.steal_half_min:
                    moved = tuple(vq.popleft() for _ in range(n // 2 - 1))
            if moved:
                # tail-append on the (dry) thief shard: keeps the moved
                # batch's relative FIFO order and never jumps ahead of a
                # concurrently re-queued surrendered task (push_front),
                # whose head slot is part of the per-core FIFO contract.
                # A racing local push may land ahead of the batch — that
                # only affects cross-shard age order, which stealing
                # never guaranteed.
                with self._locks[shard]:
                    self._qs[shard].extend(moved)
                self.steal_batches.add(1)
                self.steal_batch_tasks.add(len(moved))
            self._approx_len.add(-1)
            self.steals.add(1)
            return t, victim
        return None, -1

    def __len__(self):
        return max(0, self._approx_len.value)
