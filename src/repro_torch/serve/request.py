"""Serve-side request/response plumbing.

``RequestQueue`` is the engine's arrival channel, wired through the
monitored-I/O shim exactly like ``UMTPrefetcher``: a consumer task that
blocks in :meth:`RequestQueue.get` writes the paper's block event, so the
runtime can schedule prefill, decode, or response work on that core while
the queue is empty — request wait is a *monitored block*, not a busy core.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np

from ..core import io


class Request:
    """One generation request: a prompt plus generation budget.

    ``tokens``: int32 prompt of shape (P,) — or (P, K) for audio-codebook
    frontends; ``patches``: optional (n_patches, d_model) vision embeddings;
    ``max_new_tokens``: total tokens to emit (the prefill argmax counts as
    the first one, matching the one-shot serve path).

    ``eos_id`` / ``stop``: early-stop conditions checked on the emitted
    greedy stream — generation ends the tick the stream emits ``eos_id``,
    or the tick its tail equals one of the ``stop`` sequences (lists of
    token ids).  The stopping token/sequence is *included* in
    ``out_tokens``, so the output is always a prefix of the one-shot
    greedy row; the engine frees the slot (and its KV pages) the same
    tick.  Not supported for audio-codebook frontends (a step emits a
    codebook vector, not one id).

    Preemption (policy-driven): an evicted request keeps ``out_tokens``
    and re-enters admission with ``resume`` set (recompute-on-restore).
    Two restore shapes, chosen by the engine per model config:

    * **prefill replay** (extent-invariant configs, same gating as
      chunked prefill): one prefill over ``prefill_tokens`` — the
      original prompt plus every emitted token except the last, whose
      cache entry the never-evicted run would not have written yet
      either — whose argmax re-derives that last token bit-exactly;
    * **decode replay** (MoE capacity / SSD chunking / SWA rings are
      sequence-extent-bound, so a longer prefill is *not* bit-equal):
      prefill over the original prompt only, then the recorded tokens
      are re-fed one tick at a time through the serve step — the same
      computation the first pass ran, so bit-exact by construction."""

    __slots__ = ("rid", "tokens", "patches", "max_new", "out_tokens",
                 "t_submit", "t_first", "t_done", "done", "slot", "error",
                 "eos_id", "stop", "stopped", "pages", "total_len",
                 "evictions", "resume", "restore_tokens", "prefix_hold",
                 "spec_drafted", "spec_accepted")

    def __init__(self, rid, tokens, patches=None, max_new_tokens: int = 16,
                 eos_id: int | None = None, stop=None):
        assert max_new_tokens >= 1
        self.rid = rid
        self.tokens = tokens
        self.patches = patches
        self.max_new = max_new_tokens
        self.eos_id = eos_id
        self.stop = [list(s) for s in stop] if stop else None
        if self.stop:
            assert all(len(s) >= 1 for s in self.stop)
        self.stopped = False          # ended early on eos_id/stop
        self.out_tokens: list = []
        self.t_submit: float | None = None
        self.t_first: float | None = None
        self.t_done: float | None = None
        self.done = threading.Event()
        self.slot: int | None = None
        self.pages: list | None = None   # physical KV pages while live
        self.total_len: int = 0          # prompt (+ patches) length
        self.error: BaseException | None = None
        self.evictions: int = 0          # times preempted (policy evict)
        self.resume = False              # next prefill is a restore replay
        self.restore_tokens = None       # prompt + generated[:-1], host
        self.prefix_hold = None          # PrefixMatch carrying page holds
        #                                  from match (prefill thread) to
        #                                  admission, where they are
        #                                  adopted into ``pages``
        self.spec_drafted: int = 0       # draft tokens verified for this
        self.spec_accepted: int = 0      # request / how many were accepted
        #                                  (drives per-slot abandonment,
        #                                  see SchedulerPolicy.spec_draft_k)

    @property
    def needs_host_tokens(self) -> bool:
        """Early stop needs the emitted ids on the host every tick."""
        return self.eos_id is not None or bool(self.stop)

    @property
    def prefill_tokens(self):
        """What the next prefill runs over: the submitted prompt, or —
        for a prefill-replay restore — prompt + generated-so-far
        (rebuilt by the engine at each eviction)."""
        if self.resume and self.restore_tokens is not None:
            return self.restore_tokens
        return self.tokens

    def build_restore(self, prefill_replay: bool) -> None:
        """Snapshot restore state at eviction time.  ``prefill_replay``:
        build the prompt + generated[:-1] restore prompt (all host
        values by now — the engine materialises before evicting);
        otherwise the original prompt is re-prefilled and the engine
        decode-replays ``out_tokens`` afterwards."""
        if prefill_replay:
            base = np.asarray(self.tokens)
            gen = self.out_tokens[:-1]
            self.restore_tokens = base if not gen else np.concatenate(
                [base, np.asarray(gen)]).astype(base.dtype)
        else:
            self.restore_tokens = None
        self.resume = True
        self.evictions += 1

    # ---- latency accessors (seconds; None until the request completes)
    @property
    def ttft(self):
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def latency(self):
        if self.t_submit is None or self.t_done is None:
            return None
        return self.t_done - self.t_submit

    def wait(self, timeout=None):
        """Block (monitored inside a worker) until the response is ready.
        Re-raises the engine-side failure (bad request geometry, weights
        load error) instead of returning an empty token list."""
        io.wait(self.done, timeout)
        if self.error is not None:
            raise self.error
        return self.out_tokens

    def __repr__(self):
        state = ("failed" if self.error is not None
                 else "done" if self.done.is_set() else "pending")
        return f"<Request {self.rid} {state} n_out={len(self.out_tokens)}>"


class RequestQueue:
    """FIFO arrival queue; ``get()`` is a *monitored* blocking wait.

    ``put`` marks the request's submit time (arrival, for latency stats).
    ``close`` drains: queued requests are still returned, then ``get``
    yields ``None`` forever.
    """

    def __init__(self):
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._avail = threading.Event()
        self._closed = False

    def put(self, req: Request):
        with self._lock:
            if self._closed:
                raise RuntimeError("RequestQueue is closed")
            req.t_submit = time.monotonic()
            self._q.append(req)
            self._avail.set()

    def close(self):
        with self._lock:
            self._closed = True
            self._avail.set()

    def get(self):
        """Next request, blocking (monitored) until one arrives.
        Returns ``None`` once the queue is closed and drained."""
        while True:
            with self._lock:
                if self._q:
                    req = self._q.popleft()
                    if not self._q and not self._closed:
                        self._avail.clear()
                    return req
                if self._closed:
                    return None
            io.wait(self._avail)

    def get_batch(self, max_n: int | None = None):
        """Block (monitored) for the next request, then drain whatever
        else is already queued — up to ``max_n`` total — without blocking
        again.  One scheduling round's worth of arrivals, coalesced for
        batched prefill.  Returns ``None`` once closed and drained."""
        first = self.get()
        if first is None:
            return None
        batch = [first]
        with self._lock:
            while self._q and (max_n is None or len(batch) < max_n):
                batch.append(self._q.popleft())
            if not self._q and not self._closed:
                self._avail.clear()
        return batch

    def __len__(self):
        with self._lock:
            return len(self._q)
