"""The UMT runtime: Nanos6-style workers + Leader Thread + idle pool,
driven by the per-core eventfd channels (paper §III).

Flow (paper Fig. 1):
  * one worker is spawned bound to each core; spawning reports an
    *unblock* on its core, so ``ready[core]`` converges to the number of
    runnable workers bound there;
  * any monitored blocking op writes a block event; the Leader Thread
    (epolling all eventfds with the paper's 1 ms periodic rescan) sees
    ``ready[core] == 0`` with tasks pending and wakes an idle-pool worker
    onto that core;
  * when the blocked worker returns, the core is oversubscribed; at the
    next task scheduling point (start/finish/create/taskwait/taskyield) a
    worker re-reads its core's counters and self-surrenders to the pool;
  * parking in the pool is itself a monitored block, so the surrender
    event propagates through the same channel (paper Fig. 1, T5).

``umt=False`` gives the baseline Nanos6 model: same task graph, one worker
per core, no event channel — a blocked worker leaves its core idle.

Sharded scheduler fast path (``sched="sharded"``, the default)
--------------------------------------------------------------
The ready queue is sharded per core (``ShardedReadyQueue``): producers
push to their own core's deque, consumers pop their local deque FIFO and
steal from a neighbour only when local is dry — the oldest task, or
*half* the victim's deque when the imbalance is large (thief dry, victim
holding ``steal_half_min``+ tasks), so a burst fanned out on one core
spreads in O(log) steals — the user-space analogue of scx/sched_ext
per-CPU dispatch queues with a load-balancing hook.  Everything the hot path touches is per-core: each
shard has its own lock, the per-core ready counters have per-core locks,
and ``len(ready)`` reads an approximate lock-free ``AtomicCounter``.
``push_ready`` is O(1): it drains and idle-checks only the *target*
core's channel instead of scanning every core per submission.

Fidelity note (paper §III): the paper's Nanos6 scheduler is one global
FIFO; its per-core state is only the block/unblock *counters*.  Sharding
the queue preserves the observable contract — per-core FIFO order, work
conservation via stealing plus the Leader's epoll/1 ms-rescan global
fallback (which remains the authority for waking idle-pool workers onto
idle cores) — while removing the global lock and the O(n_cores) eventfd
drains from every submission.  ``sched="global"`` keeps the paper-shaped
single queue for comparison (benchmarks/sched.py measures both).
"""
from __future__ import annotations

import os
import select
import threading
import time

from .eventchannel import umt_enable
from .monitor import current_worker, io, umt_thread_ctrl
from .task import (AtomicCounter, DependencyTracker, ReadyQueue,
                   ShardedReadyQueue, Task)
from .topology import detect_topology
from .tracing import Tracer


class Worker(threading.Thread):
    # worker ids are allocated from both the main thread (runtime init,
    # submit-time growth) and the Leader thread (leader_scan) — an
    # AtomicCounter makes the id handout race-free
    _ids = AtomicCounter()

    def __init__(self, rt: "UMTRuntime", core: int):
        self.wid = Worker._ids.add(1)
        super().__init__(name=f"umt-worker-{self.wid}", daemon=True)
        self.rt = rt
        self.core = core
        self.sem = threading.Semaphore(0)
        self.monitored = rt.umt
        self.current_task: Task | None = None
        self.surrender_flag = False
        # consecutive oversubscribed scheduling points observed (surrender
        # hysteresis, paper-strict at rt.surrender_hysteresis == 1)
        self.oversub_streak = 0

    # ---- channel plumbing used by the __schedule() shim ----
    def block_channel(self):
        return self.rt._ch_block(self.core)

    def unblock_channel(self):
        # read *after* a possible migration: the wake is reported on the
        # core the Leader re-targeted us to (kernel semantics).
        return self.rt._ch_unblock(self.core)

    def on_block(self):
        self.rt.tracer.ev("block", self.wid, self.core)

    def on_unblock(self):
        self.rt.tracer.ev("unblock", self.wid, self.core)

    def migrate(self, new_core: int):
        """Paper §III-B migration compensation: a worker moved while
        *runnable* never wrote a block event on its old core, so the move
        itself must write the missed (block@old, unblock@new) pair.

        A *blocked/parked* worker already reported its block on the old
        core and will report its unblock on whatever core it wakes on —
        re-target it with ``retarget()`` instead (no compensation)."""
        old = self.core
        if old == new_core:
            return
        if self.monitored:
            self.rt._ch_block(old).write_block()
            self.rt._ch_unblock(new_core).write_unblock()
            self.rt.tracer.ev("block", self.wid, old)
            self.rt.tracer.ev("unblock", self.wid, new_core)
        self.core = new_core

    def retarget(self, new_core: int):
        """Re-bind a *blocked* worker (wake-time migration, no events)."""
        self.core = new_core

    # ---- main loop ----
    def run(self):
        umt_thread_ctrl(self)
        rt = self.rt
        if self.monitored:
            self.unblock_channel().write_unblock()  # became runnable here
        rt.tracer.ev("spawn", self.wid, self.core)
        while rt.running:
            task = rt.next_task(self)
            if task is None and rt.spin_before_park_us:
                task = rt.spin_for_task(self)
            if task is None:
                if not rt.park(self):
                    break
                continue
            # scheduling point: task start
            if rt.sched_point(self):
                rt.requeue_front(task, self.core)
                if not rt.park(self, force=True):
                    break
                continue
            rt.run_task(self, task)
            # scheduling point: task finish
            if rt.sched_point(self) and rt.running:
                if not rt.park(self, force=True):
                    break
        umt_thread_ctrl(None)


class Leader(threading.Thread):
    """The paper's Leader Thread: epoll over all eventfds + 1 ms rescan.

    Batched drains: one wakeup coalesces *all* currently-ready eventfds
    (re-polling at timeout 0 until quiet) into a set of dirty cores, then
    drains each core once and runs at most one ``leader_scan`` — on
    fine-grained blocking graphs a single wakeup used to cost one drain
    *and one full scan per event*.  The scan is additionally rate-limited
    to ``scan_min_gap`` (default ``scan_interval / 2``): a skipped scan is
    rescheduled within the remaining gap, so the paper's 1 ms rescan
    guarantee still bounds wake latency.
    """

    def __init__(self, rt: "UMTRuntime"):
        super().__init__(name="umt-leader", daemon=True)
        self.rt = rt

    def run(self):
        rt = self.rt
        ep = select.epoll()
        fd2core = {}
        for ch in rt.channels:
            ep.register(ch.fd, select.EPOLLIN)
            fd2core[ch.fd] = ch.core
        ep.register(rt._wake_r, select.EPOLLIN)
        # The 1 ms rescan is only a fallback for racy counters — eventfd
        # writes wake epoll instantly — so back off exponentially while
        # nothing happens (keeps overhead near zero on compute phases).
        timeout = rt.scan_interval
        last_scan = 0.0
        try:
            while rt.running:
                events = ep.poll(timeout)
                if events:
                    timeout = rt.scan_interval
                    rt.stats_extra["leader_wakeups"] += 1
                else:
                    timeout = min(timeout * 2, 0.05)
                # coalesce this wakeup: drain every ready core once per
                # round, re-poll(0) for events written while draining
                # (bounded rounds — the fds are level-triggered, so the
                # re-poll must come *after* the drain)
                for _ in range(4):
                    cores = set()
                    for fd, _ in events:
                        if fd == rt._wake_r:
                            try:
                                os.read(rt._wake_r, 8)
                            except BlockingIOError:
                                pass
                        else:
                            cores.add(fd2core[fd])
                    for core in cores:
                        rt.drain_core(core)
                    rt.stats_extra["leader_drains"] += len(cores)
                    if not cores:
                        break
                    events = ep.poll(0)
                    if not events:
                        break
                if not rt.running:
                    break
                now = time.monotonic()
                since = now - last_scan
                if since >= rt.scan_min_gap:
                    rt.leader_scan()
                    rt.stats_extra["leader_scans"] += 1
                    last_scan = now
                else:
                    # a scan is owed: sleep at most the remaining gap
                    timeout = max(min(timeout, rt.scan_min_gap - since),
                                  1e-4)
        finally:
            ep.close()


class UMTRuntime:
    """notify: "all" — every block/unblock is written (the paper's
    implemented design); "idle_only" — the paper's §III-D/§V *proposed*
    v2: the (shim's) kernel side keeps a per-core running count and only
    writes an event on the 1->0 (core idle) and 0->1 (core busy again)
    transitions, cutting event traffic and making counter overflow moot.

    sched: "sharded" — per-core ready deques + work stealing (the fast
    path, see module docstring); "global" — the single global FIFO the
    paper's Nanos6 uses (kept for comparison benchmarks).

    topology: optional (n_cores, n_cores) distance matrix; the sharded
    scheduler's steal walk then visits victims nearest-distance-first
    (cache/NUMA-aware, scx-style) instead of nearest-index.

    surrender_hysteresis: a worker self-surrenders only after this many
    *consecutive* oversubscribed scheduling points (default 1 = the
    paper's eager rule).  On sub-ms blocking tasks the eager rule pays
    one park+wake round trip per task — a worker that is about to become
    oversubscription-free again (its blocked peer finishes in microseconds)
    parks anyway; hysteresis > 1 trades paper-strict eagerness for less
    churn (measured by ``benchmarks/sched.py --blocking``).
    """

    def __init__(self, n_cores: int | None = None, umt: bool = True,
                 max_workers_per_core: int = 8, scan_interval: float = 0.001,
                 trace: bool = True, notify: str = "all",
                 sched: str = "sharded", scan_min_gap: float | None = None,
                 topology="auto", surrender_hysteresis: int = 1,
                 spin_before_park_us: float = 0):
        assert notify in ("all", "idle_only")
        assert sched in ("sharded", "global")
        assert surrender_hysteresis >= 1
        assert spin_before_park_us >= 0
        # bounded idle-spin before parking (0 = paper-strict eager park):
        # a dry worker polls its queue for this many microseconds before
        # paying the park/wake round-trip — see spin_for_task
        self.spin_before_park_us = spin_before_park_us
        self.n_cores = n_cores or os.cpu_count() or 1
        self.umt = umt
        self.notify = notify
        self.sched = sched
        self.sharded = sched == "sharded"
        self.surrender_hysteresis = surrender_hysteresis
        # Leader scan rate limit (see Leader docstring); 0 disables
        self.scan_min_gap = (scan_interval / 2 if scan_min_gap is None
                             else scan_min_gap)
        # "kernel-side" per-core runnable counts for idle_only mode;
        # per-core locks — one core's transitions never contend another's
        self._krun = [0] * self.n_cores
        self._krun_locks = [threading.Lock() for _ in range(self.n_cores)]
        self.scan_interval = scan_interval
        self.max_workers = max_workers_per_core * self.n_cores
        self.running = True
        self.tracer = Tracer(trace)
        # "auto" (default) derives the steal-distance matrix from the
        # host's sysfs cache hierarchy; flat/undetectable hosts resolve
        # to None — the ring walk, bit-for-bit the pre-topology
        # behaviour.  Pass None to force flat, or an explicit matrix.
        if isinstance(topology, str):
            assert topology == "auto"
            topology = detect_topology(self.n_cores)
        self.topology = topology
        self.ready = (ShardedReadyQueue(self.n_cores, topology=topology)
                      if self.sharded else ReadyQueue())
        self.deps = DependencyTracker()
        self.channels = umt_enable(self.n_cores)
        self.ready_count = [0] * self.n_cores     # user-space per-core count
        self._count_locks = [threading.Lock() for _ in range(self.n_cores)]
        self._pool: list[Worker] = []
        self._pool_lock = threading.Lock()
        self._workers: list[Worker] = []
        self._outstanding = 0
        self._quiet_lock = threading.Lock()       # outstanding/quiet only —
        self._quiet = threading.Event()           # never shared with the
        self._quiet.set()                         # per-core counter paths
        self._wake_r, self._wake_w = os.pipe2(os.O_NONBLOCK)
        self.stats_extra = {"wakes": 0, "surrenders": 0,
                            "surrender_deferrals": 0, "spawned": 0,
                            "leader_wakeups": 0, "leader_drains": 0,
                            "leader_scans": 0, "spin_claims": 0}

        for c in range(self.n_cores):
            self._spawn(c)
        self.leader = Leader(self)
        if self.umt:
            self.leader.start()

    # ------------------------------------------------------------ lifecycle
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    def shutdown(self):
        if not self.running:        # idempotent: fds are closed below
            return
        self.wait_all()
        self.running = False
        with self._pool_lock:
            pool = list(self._pool)
            self._pool.clear()
        for w in pool:
            w.sem.release()
        for w in list(self._workers):
            w.sem.release()
        try:
            os.write(self._wake_w, b"\x01" * 8)
        except BlockingIOError:
            pass
        for w in self._workers:
            w.join(timeout=5)
        if self.umt:
            self.leader.join(timeout=5)
        for ch in self.channels:
            ch.close()
        os.close(self._wake_r)
        os.close(self._wake_w)

    def _spawn(self, core: int) -> Worker:
        w = Worker(self, core)
        self._workers.append(w)
        self.stats_extra["spawned"] += 1
        w.start()
        return w

    # ------------------------------------------------------------ submission
    def submit(self, fn, *args, in_=(), out=(), name=None, **kwargs) -> Task:
        parent_w = current_worker()
        parent = parent_w.current_task if isinstance(parent_w, Worker) and \
            parent_w.rt is self else None
        t = Task(fn, args, kwargs, in_, out, name, parent)
        with self._quiet_lock:
            self._outstanding += 1
            self._quiet.clear()
        if parent is not None:
            with self.deps.lock:
                parent.children_left += 1
                parent.child_done_ev.clear()
        n = self.deps.register(t)
        if n == 0:
            self.push_ready(t)
        # scheduling point: task creation (counter refresh; a surrender
        # mid-task is not possible at user level — see DESIGN fidelity
        # ledger — the start/finish points carry the surrender action).
        if parent is not None and self.umt:
            self.drain_core(parent_w.core, lazy=self.sharded)
        return t

    def task(self, fn=None, **opts):
        """Decorator sugar: ``@rt.task(out=("x",))``."""
        def deco(f):
            def submitter(*args, **kw):
                return self.submit(f, *args, **opts, **kw)
            submitter.__name__ = f.__name__
            return submitter
        return deco(fn) if fn is not None else deco

    def push_ready(self, t: Task, needs_consumer: bool = False):
        if not self.sharded:
            self._push_ready_global(t)
            return
        w = current_worker()
        if isinstance(w, Worker) and w.rt is self:
            core = w.core                       # cache affinity
            # a worker fanning out mid-task won't pop again until the
            # parent task ends — these pushes need their own consumer
            needs_consumer |= w.current_task is not None
        else:
            core = self.ready.select_shard()
        self.ready.push(t, core)
        if not self.umt:
            self._wake_for_work(core)
            return
        # O(1) fast path: drain + idle-check only the *target* core, and
        # only if its channel is dirty.  Target core idle -> targeted
        # wake.  Target core busy -> usually someone visits this shard
        # soon (a completing worker pops next; main-thread round-robin
        # spreads over all shards), EXCEPT when the pusher is known not
        # to come back for this task (mid-task fan-out, completion
        # fan-out beyond the first successor): parked workers can't
        # steal on their own, so hand the task to any pool worker (it
        # will steal it).  All reads are racy/approximate — the Leader's
        # epoll/1 ms rescan (paper §III) stays the global fallback.
        self.drain_core(core, lazy=True)
        if self.ready_count[core] <= 0:       # racy read: approximate
            self._wake_for_work(core)
        elif needs_consumer and self._pool:   # racy read: approximate
            self._wake_for_work()

    def _push_ready_global(self, t: Task):
        """Pre-sharding push path (sched="global"): global FIFO + full
        drain of every core per submission — kept for benchmarks."""
        self.ready.push(t)
        # Baseline has no leader: always self-wake.  In UMT mode the Leader
        # is the waker; waking on *every* push causes park/wake churn when
        # the dependency wavefront briefly starves the queue — but if some
        # core is genuinely idle we wake immediately rather than waiting
        # for the 1 ms scan.
        if not self.umt:
            self._wake_for_work()
        else:
            for c in range(self.n_cores):
                self.drain_core(c)
            idle = any(rc <= 0 for rc in self.ready_count)
            if idle:
                self._wake_for_work()

    def _wake_for_work(self, core: int | None = None) -> bool:
        """Wake (at most) one idle-pool worker; prefer one already bound
        to ``core`` (cache affinity), re-target another otherwise.
        Returns False when the pool was empty."""
        w = None
        with self._pool_lock:
            if core is not None:
                for i, cand in enumerate(self._pool):
                    if cand.core == core:
                        w = self._pool.pop(i)
                        break
            if w is None and self._pool:
                w = self._pool.pop()
        if w is None:
            return False
        if core is not None and w.core != core:
            w.retarget(core)     # parked == blocked: no compensation pair
        self.stats_extra["wakes"] += 1
        w.sem.release()
        return True

    # ------------------------------------------------------------ dispatch
    def next_task(self, w: Worker):
        """Worker dispatch: local shard FIFO, then steal, (global mode:
        single queue pop)."""
        if not self.sharded:
            return self.ready.pop()
        t = self.ready.pop_local(w.core)
        if t is not None:
            return t
        t, victim = self.ready.steal(w.core)
        if t is not None:
            self.tracer.ev("steal", w.wid, w.core, victim)
        return t

    def requeue_front(self, task: Task, core: int):
        """Put a claimed-but-not-started task back at the head (surrender
        path) so per-core FIFO order is preserved."""
        if self.sharded:
            self.ready.push_front(task, core)
        else:
            self.ready.push_front(task)

    # ------------------------------------------------------------ execution
    def run_task(self, w: Worker, t: Task):
        w.current_task = t
        t.state = "running"
        self.tracer.ev("task_start", w.wid, w.core, t.name)
        try:
            t.result = t.fn(*t.args, **t.kwargs)
        except BaseException as e:  # noqa: BLE001 — propagate via handle
            t.exc = e
        self.tracer.ev("task_end", w.wid, w.core, t.name)
        w.current_task = None
        self.complete(t)

    def complete(self, t: Task):
        with self.deps.lock:
            t.state = "done"
            t.done_ev.set()
            succs, t.succs = list(t.succs), []
            newly_ready = []
            for s in succs:
                s.pending -= 1
                if s.pending == 0:
                    newly_ready.append(s)
            p = t.parent
            if p is not None:
                p.children_left -= 1
                if p.children_left == 0:
                    p.child_done_ev.set()
        for i, s in enumerate(newly_ready):
            # the completing worker pops exactly one task next — further
            # successors need their own consumer woken
            self.push_ready(s, needs_consumer=i > 0)
        with self._quiet_lock:
            self._outstanding -= 1
            if self._outstanding == 0:
                self._quiet.set()

    # ------------------------------------------------------ UMT bookkeeping
    class _NullChannel:
        def write_block(self):
            pass

        def write_unblock(self):
            pass

    _NULL = _NullChannel()

    def _ch_block(self, core: int):
        """Channel a block event should be written to.  idle_only mode
        fires only on the 1 -> 0 (core went idle) transition of the
        kernel-side running count."""
        if self.notify != "idle_only":
            return self.channels[core]
        with self._krun_locks[core]:
            self._krun[core] -= 1
            fire = self._krun[core] <= 0
        return self.channels[core] if fire else self._NULL

    def _ch_unblock(self, core: int):
        """idle_only: fire only on 0 -> 1 (core busy again)."""
        if self.notify != "idle_only":
            return self.channels[core]
        with self._krun_locks[core]:
            was_idle = self._krun[core] <= 0
            self._krun[core] += 1
        return self.channels[core] if was_idle else self._NULL

    def drain_core(self, core: int, lazy: bool = False):
        """Fold one core's pending (blocked, unblocked) events into its
        ready count.  ``lazy=True`` (sharded hot paths) skips the
        eventfd_read syscall when the channel's dirty flag says nothing
        was written since the last drain — exact, not approximate: the
        counter only moves when events are written.  The global mode
        always force-drains (pre-PR behaviour, kept for benchmarks), as
        does the Leader's epoll path (a level-triggered epoll on an
        undrained fd must actually drain it or it would spin)."""
        ch = self.channels[core]
        blocked, unblocked = ch.read_if_dirty() if lazy else ch.read()
        if blocked or unblocked:
            with self._count_locks[core]:
                self.ready_count[core] += unblocked - blocked

    def leader_scan(self):
        """Wake an idle worker onto every idle core that has pending work.

        ``len(self.ready)`` is the sharded queue's approximate lock-free
        counter — the scan never takes a queue lock; a stale read is
        corrected by the next rescan (<= 50 ms away)."""
        if len(self.ready) == 0:
            return
        for core in range(self.n_cores):
            if len(self.ready) == 0:
                break
            with self._count_locks[core]:
                idle = self.ready_count[core] <= 0
            if not idle:
                continue
            if not self._wake_for_work(core):
                # pool dry: grow the worker set instead (paper Fig. 1 T3)
                if len(self._workers) < self.max_workers:
                    self._spawn(core)

    def sched_point(self, w: Worker) -> bool:
        """Paper §III-C: drain own-core counters; surrender if >1 ready.
        Returns True when the worker should park.

        Surrender hysteresis: oversubscription must be observed at
        ``surrender_hysteresis`` *consecutive* scheduling points before
        the worker actually parks (any non-oversubscribed point resets
        the streak).  At the default of 1 this is the paper's eager rule
        verbatim; higher values keep a worker on its core across the
        sub-ms blips where a blocked peer returns and finishes almost
        immediately, cutting park/wake churn (deferred surrenders are
        counted in ``surrender_deferrals``)."""
        if not self.umt or not isinstance(w, Worker):
            return False
        if self.notify == "idle_only":
            # v2 kernel exposes the per-core ready count read-only; the
            # eventfd only carries idle/busy edges.
            with self._krun_locks[w.core]:
                over = self._krun[w.core] > 1
        else:
            self.drain_core(w.core, lazy=self.sharded)
            with self._count_locks[w.core]:
                over = self.ready_count[w.core] > 1
        if not over:
            w.oversub_streak = 0
            return False
        w.oversub_streak += 1
        if w.oversub_streak < self.surrender_hysteresis:
            self.stats_extra["surrender_deferrals"] += 1
            return False
        w.oversub_streak = 0
        self.stats_extra["surrenders"] += 1
        self.tracer.ev("surrender", w.wid, w.core)
        return True

    # ------------------------------------------------------------ parking
    def spin_for_task(self, w: Worker):
        """Bounded idle-spin before parking: a dry worker re-polls the
        ready queue for ``spin_before_park_us`` before paying the
        park/wake round-trip (semaphore block + Leader epoll + eventfd
        drain).  Wins when tasks arrive at sub-wake-latency cadence
        (fine-grained fan-out), burns the core for nothing when the
        queue stays dry — hence the default of 0, which is the paper's
        eager-park rule verbatim.  The spinning worker stays *runnable*
        (no block event), so the kernel-side counters see the core as
        busy the whole window.  Returns a claimed task, or None when the
        window expires (measured A/B in benchmarks/sched.py)."""
        deadline = time.perf_counter() + self.spin_before_park_us * 1e-6
        while self.running and time.perf_counter() < deadline:
            task = self.next_task(w)
            if task is not None:
                self.stats_extra["spin_claims"] += 1
                return task
            # a hardware runtime would pause-spin; here the poll must
            # yield the GIL or the spinner starves producers for a whole
            # switch interval (~5 ms) and inverts the win
            time.sleep(0)
        return None

    def parked(self, w: Worker) -> bool:
        with self._pool_lock:
            return w in self._pool

    def park(self, w: Worker, force: bool = False) -> bool:
        """Return worker to the idle pool; blocks (monitored). Returns
        False when the runtime is shutting down.

        ``force=True`` (self-surrender) skips the lost-wakeup recheck —
        the worker *wants* to leave the core even though work is pending.

        Manual event bracketing (not ``io.acquire``): the block event is
        pinned to the *park-entry* core.  A waker pops us from the pool
        and may retarget ``w.core`` before we write the block; pinning
        guarantees the (block@entry, unblock@wake) pair still brackets
        the migration instead of collapsing onto the new core and
        leaving a phantom ready count on the old one.  The no-event fast
        path (token already available) is only taken when we were not
        retargeted — a zero-length block on the *same* core is
        unobservable, a migrated one is not.
        """
        if not self.running:
            return False
        entry_core = w.core
        with self._pool_lock:
            self._pool.append(w)
        if not force and len(self.ready) > 0:
            # lost-wakeup guard: work arrived between pop() and park
            with self._pool_lock:
                if w in self._pool:
                    # still ours to remove -> nobody popped/retargeted us
                    self._pool.remove(w)
                    return self.running     # loop around and re-pop
            # someone woke us already: eat the token below
        got = w.sem.acquire(blocking=False)
        if got and w.core == entry_core:
            # fast path: never actually blocked, never moved — no events
            # owed (and w is already out of the pool, so no later
            # retarget can invalidate the check)
            return self.running
        if w.monitored:
            self._ch_block(entry_core).write_block()
        # tracing is mode-independent (honest baseline CPU% needs idle
        # visibility); pinned to entry core like the kernel-side event
        self.tracer.ev("block", w.wid, entry_core)
        if not got:
            w.sem.acquire()        # ← the actual block
        if w.monitored:
            # reported on the (possibly re-targeted) wake core
            w.unblock_channel().write_unblock()
        w.on_unblock()
        return self.running

    # ------------------------------------------------------------ waiting
    def taskwait(self):
        """Wait for the current task's children (or all tasks if called
        from outside).  A scheduling point and a monitored block."""
        w = current_worker()
        if isinstance(w, Worker) and w.rt is self and w.current_task:
            ev = w.current_task.child_done_ev
            io.wait(ev)
            self.sched_point(w)
        else:
            self.wait_all()

    def taskyield(self):
        """Scheduling point (paper §IV-B: cheap oversubscription check)."""
        w = current_worker()
        if isinstance(w, Worker) and w.rt is self:
            self.drain_core(w.core, lazy=self.sharded)

    def wait_all(self, timeout=None):
        return self._quiet.wait(timeout)

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        s = self.tracer.stats(self.n_cores)
        s.update(self.stats_extra)
        s["steals"] = (self.ready.steals.value if self.sharded else 0)
        # batch steals: a dry worker taking half an overloaded victim's
        # deque in one pass (see ShardedReadyQueue.steal)
        s["steal_batches"] = (self.ready.steal_batches.value
                              if self.sharded else 0)
        s["steal_batch_tasks"] = (self.ready.steal_batch_tasks.value
                                  if self.sharded else 0)
        s["n_workers"] = len(self._workers)
        s["umt"] = self.umt
        s["sched"] = self.sched
        return s
