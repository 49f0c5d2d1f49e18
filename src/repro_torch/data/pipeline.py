"""Token data pipeline with UMT-overlapped prefetch.

Determinism contract: ``batch_for_step(step)`` is a pure function of
(seed, step, batch geometry) for the synthetic source, and of the shard
manifest for the file-backed source — so restart/resume at step k replays
the identical batch stream (tested), which checkpoint/restart requires.

Prefetch: each upcoming batch is fetched by a UMT *task* whose blocking
file reads go through the monitored-I/O shim — a slow disk read idles no
core, the runtime schedules the next fetch (or a checkpoint write) there.
Straggling fetches are re-issued after a deadline (first result wins).
"""
from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

from ..core import UMTRuntime, io


def batch_for_step(step: int, *, seed: int, batch: int, seq: int,
                   vocab: int, accum: int = 1, extra_dim: int = 0):
    """Synthetic deterministic batch, leaves (accum, micro, seq[, K])."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    shape = (accum, batch // accum, seq)
    if extra_dim:
        shape = shape + (extra_dim,)
    tokens = rng.integers(0, vocab, size=shape, dtype=np.int32)
    return {"tokens": tokens, "labels": tokens}


class SyntheticTokenSource:
    def __init__(self, *, seed: int, batch: int, seq: int, vocab: int,
                 accum: int = 1, extra_dim: int = 0):
        self.kw = dict(seed=seed, batch=batch, seq=seq, vocab=vocab,
                       accum=accum, extra_dim=extra_dim)

    def fetch(self, step: int):
        return batch_for_step(step, **self.kw)


def write_token_shards(path: str, *, n_shards: int, tokens_per_shard: int,
                       vocab: int, seed: int = 0) -> str:
    """Create a binary shard directory + manifest (test/demo corpus)."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n_shards):
        arr = rng.integers(0, vocab, size=tokens_per_shard, dtype=np.int32)
        name = f"shard_{i:05d}.bin"
        with open(os.path.join(path, name), "wb") as f:
            f.write(arr.tobytes())
        names.append(name)
    manifest = {"shards": names, "tokens_per_shard": tokens_per_shard,
                "vocab": vocab, "dtype": "int32"}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return path


class ShardedTokenSource:
    """File-backed source: step -> (shard, offset) mapping is static."""

    def __init__(self, path: str, *, batch: int, seq: int, accum: int = 1):
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.path = path
        self.batch, self.seq, self.accum = batch, seq, accum
        self.tokens_per_batch = batch * (seq + 1)
        tps = self.manifest["tokens_per_shard"]
        self.batches_per_shard = tps // self.tokens_per_batch
        assert self.batches_per_shard > 0, "shards smaller than a batch"
        self.n_batches = self.batches_per_shard * len(
            self.manifest["shards"])

    def locate(self, step: int):
        idx = step % self.n_batches
        shard = idx // self.batches_per_shard
        off = (idx % self.batches_per_shard) * self.tokens_per_batch * 4
        return self.manifest["shards"][shard], off

    def fetch(self, step: int):
        name, off = self.locate(step)
        n = self.tokens_per_batch * 4
        with open(os.path.join(self.path, name), "rb") as f:
            f.seek(off)
            raw = io.read(f, n)            # monitored blocking read
        arr = np.frombuffer(raw, np.int32).reshape(self.batch, self.seq + 1)
        micro = self.batch // self.accum
        tok = arr[:, :-1].reshape(self.accum, micro, self.seq)
        lab = arr[:, 1:].reshape(self.accum, micro, self.seq)
        return {"tokens": tok, "labels": lab}


class UMTPrefetcher:
    """Bounded look-ahead prefetch on a UMT runtime, with straggler
    re-issue (duplicate fetch after `reissue_after` seconds; first wins).
    """

    def __init__(self, source, rt: UMTRuntime, *, depth: int = 2,
                 start_step: int = 0, reissue_after: float = 5.0):
        self.source = source
        self.rt = rt
        self.depth = depth
        self.reissue_after = reissue_after
        self.results: dict[int, object] = {}
        self.lock = threading.Lock()
        self.done: dict[int, threading.Event] = {}
        self.issued_at: dict[int, float] = {}
        self.reissued = 0
        self.next_to_issue = start_step
        for _ in range(depth):
            self._issue(self.next_to_issue)
            self.next_to_issue += 1

    def _issue(self, step: int):
        with self.lock:
            self.done.setdefault(step, threading.Event())
            self.issued_at.setdefault(step, time.monotonic())

        def fetch():
            self._fulfil(step, self.source.fetch(step))

        self.rt.submit(fetch, name=f"prefetch{step}")

    def _fulfil(self, step: int, out):
        """Publish a fetched batch — state lookup and result insert under
        one lock.  A straggler (re-issued fetch's loser) that completes
        *after* ``get()`` already popped the step's state must be a no-op:
        unguarded, it would KeyError on ``self.done[step]`` (swallowed
        into the task's exc) and re-insert a never-collected entry into
        ``self.results``."""
        with self.lock:
            ev = self.done.get(step)
            if ev is None:          # already collected: late retry, drop
                return
            if step not in self.results:
                self.results[step] = out
            ev.set()

    def get(self, step: int):
        """Blocks (monitored if called from a worker) until batch ready."""
        with self.lock:
            ev = self.done.get(step)
        if ev is None:
            self._issue(step)
            ev = self.done[step]
        # straggler mitigation: re-issue once if the fetch is late
        if not ev.wait(self.reissue_after):
            self.reissued += 1
            self._reissue(step)
            io.wait(ev)
        while self.next_to_issue <= step + self.depth:
            self._issue(self.next_to_issue)
            self.next_to_issue += 1
        with self.lock:
            out = self.results.pop(step)
            self.done.pop(step, None)
            self.issued_at.pop(step, None)
        return out

    def _reissue(self, step: int):
        def fetch():
            self._fulfil(step, self.source.fetch(step))
        self.rt.submit(fetch, name=f"prefetch{step}.retry")
