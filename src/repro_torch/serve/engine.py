"""Continuous-batching serve engine on the UMT runtime (PyTorch port of
the main path of ``repro/serve/engine.py``) — the *mechanism* half of the
mechanism/policy split; decisions come from :mod:`.policy`.

A fixed pool of ``slots`` serve slots shares one batched KV cache whose
linear attention leaves are paged (physical pages from a free list,
:class:`.pager.PagePool`, reserved worst-case at admission and freed the
moment a request finishes) or, with ``page_size=None``, dense per-slot
rows.  The same task graph as the reference runs on the port's
``UMTRuntime``:

  * **intake**   — blocks on the request queue (monitored ``io.wait``);
  * **prefill**  — one task per coalesced arrival round, one batched
    prefill per prompt shape, batch padded to a power of two; with
    ``prefill_chunk=C`` a prompt longer than C prefills as cache-append
    chunks of C tokens, each chunk its own **continuation task**, so
    decode ticks and other rounds interleave between chunks;
  * **decode**   — the driver: admit prefilled rows (blocking on free
    pages, never corrupting), one masked decode tick over the pool under
    the pool lock, then finish completed requests *before* freeing their
    pages; blocks (monitored) when no slot is live;
  * **respond**  — one task per finished request when a sink is set;
  * **weights**  — optional: when ``params`` is a callable it runs as a
    task at start, so weights load while intake waits.

Device work from every task goes to the current (default) CUDA stream;
see :mod:`.kvstate` for why that makes the reference's buffer pins
unnecessary.  The host blocks on the device only where the reference
forces the chain: the first-token fetch of a prefill round (TTFT), one
small token fetch per tick while an ``eos_id``/``stop`` request is live,
and the token fetch of each finished request, which runs before its
pages are freed.

Correctness bar (tested): each request's greedy tokens equal the
one-shot path's (a prefix of them under ``eos_id``/``stop``) for any
arrival order and slot schedule.

Shared-prefix KV reuse (``prefix_cache``, the reference's rule: "auto"
is on for a paged engine on a chunk-exact config): admitted prompts'
full pages enter a radix trie (:mod:`.prefix`); a prompt whose prefix is
cached gathers those pages into a fresh row (the fork page, a partial
match, copied: copy-on-write) and chunk-prefills only its tail; its slot
then shares the prefix pages, which the insert never writes.  Every
gather, insert and tick is enqueued on the one stream under the pool
lock, so a gather reads pages before any later write of them, and a
page is adopted by the trie only after the insert that fills it is
enqueued.

Options of the reference that belong to later slices raise
``NotImplementedError`` naming their ROADMAP item: ``spec``, on-demand
policies (eviction and restore) and tensor parallelism (``tp``/``mesh``).
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from ..core import UMTRuntime, io
from ..device import resolve_device
from ..models.lm import init_cache
from ..steps import (chunkable, make_batched_insert_step, make_decode_step,
                     make_prefill_chunk_step, make_prefill_step,
                     make_prefix_gather_step)
from .kvstate import KVState
from .pager import GARBAGE_PAGE
from .policy import make_policy
from .prefix import PrefixCache
from .request import Request, RequestQueue


def percentile(xs, q):
    """Nearest-rank percentile of a pre-sorted list (None when empty)."""
    return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else None


def auto_page_size(cache_len: int, cap: int = 8) -> int:
    """Largest divisor of ``cache_len`` that is <= ``cap``."""
    return max(d for d in range(1, min(cap, cache_len) + 1)
               if cache_len % d == 0)


def _unported(option, item):
    raise NotImplementedError(
        f"ServeEngine {option} is not ported yet (ROADMAP.md queue 1, "
        f"item {item})")


class ServeEngine:
    """Continuous-batching engine over one model + one slot pool.

    Parameters mirror ``repro.serve.ServeEngine``; ``device`` (default
    ``"cuda"``) places the weights' consumers, the pool and every step.
    ``params`` is a weights tree already on ``device`` or a zero-arg
    callable returning one (run as the weights task).  ``donate`` and
    ``spec_k`` are accepted for parity: the pool is always updated in
    place, and speculative decoding is not ported yet.
    """

    def __init__(self, cfg, params, *, slots: int = 4, cache_len: int = 64,
                 mesh=None, rt: UMTRuntime | None = None, umt: bool = True,
                 n_cores: int | None = None, response_sink=None,
                 idle_wait: float = 0.05,
                 page_size: int | str | None = "auto",
                 num_pages: int | None = None,
                 prefill_chunk: int | None = None,
                 max_prefill_batch: int | None = None,
                 sync_ticks: bool = False, donate: bool | None = None,
                 paged_kernel: bool | None = None,
                 tp: bool | None = None, policy=None,
                 prefix_cache: bool | str | None = None,
                 spec: str | None = None, spec_k: int = 4,
                 device="cuda"):
        if mesh is not None or tp:
            _unported("tensor parallelism (tp/mesh)", 9)
        if spec not in (None, "off"):
            _unported("spec (speculative decoding)", 5)
        self.policy = make_policy(policy)
        if self.policy.on_demand:
            _unported(f"policy {self.policy.name!r} (on-demand paging, "
                      "eviction and restore)", 5)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.cache_len = cache_len
        self.response_sink = response_sink
        self.idle_wait = idle_wait
        self.sync_ticks = sync_ticks
        self.rt = rt if rt is not None else UMTRuntime(
            n_cores=n_cores, umt=umt, trace=False)
        self._own_rt = rt is None
        # the baseline runtime never backfills a blocked worker's core:
        # intake + the decode driver occupy two workers for good
        if not (self.rt.umt or self.rt.n_cores >= 3):
            raise ValueError("ServeEngine on a baseline (umt=False) runtime "
                             "needs n_cores >= 3: intake and decode occupy "
                             "a worker each")
        if page_size == "auto":
            page_size = auto_page_size(cache_len)
        self.page_size: int | None = page_size
        self.paged = page_size is not None
        self.donate = True if donate is None else bool(donate)
        self.paged_kernel = bool(paged_kernel)
        if self.paged_kernel and not self.paged:
            raise ValueError("paged_kernel=True needs a paged engine "
                             "(page_size is None here)")
        self.prefill_chunk = prefill_chunk
        self._chunkable = chunkable(cfg, cache_len)
        if prefill_chunk is not None:
            assert prefill_chunk >= 1
            if not self._chunkable:
                raise ValueError(
                    f"{cfg.name}: chunked prefill needs linear-cache "
                    "attention blocks (no MoE, no SSM, no SWA ring "
                    "shorter than cache_len)")
        self.max_prefill_batch = max_prefill_batch or slots

        self.queue = RequestQueue()
        self.prefill = make_prefill_step(cfg, cache_len=cache_len)
        # the chunk step serves chunked prefill and the prefix hit's tail
        self.chunk = (make_prefill_chunk_step(cfg, cache_len)
                      if self._chunkable else None)
        # chunk width of a prefix hit's tail when the engine has no
        # prefill_chunk of its own (the reference's restore width)
        self.restore_chunk = prefill_chunk or (
            1 << ((cache_len - 1).bit_length() // 2))
        # shared-prefix KV reuse qualifies where the hit path is exact:
        # shareable pages + chunk-exact prefill of the tail
        can_prefix = self.paged and self._chunkable
        if prefix_cache in (True, "on"):
            if not can_prefix:
                raise ValueError(
                    f"{cfg.name}: prefix_cache='on' needs a paged engine "
                    "on a chunk-exact config (steps.chunkable) — the hit "
                    "path gathers shared pages into a row cache and "
                    "chunk-prefills the tail")
            self._use_prefix = True
        elif prefix_cache in (False, "off"):
            self._use_prefix = False
        elif prefix_cache in (None, "auto"):
            self._use_prefix = can_prefix
        else:
            raise ValueError(f"prefix_cache={prefix_cache!r}: pick "
                             "True/'on', False/'off' or None/'auto'")
        self.insert = make_batched_insert_step(cfg, cache_len=cache_len,
                                               page_size=page_size)
        self.decode = make_decode_step(cfg, cache_len=cache_len,
                                       page_size=page_size,
                                       paged_kernel=self.paged_kernel)

        self._params = None if callable(params) else params
        self._params_fn = params if callable(params) else None
        self._params_ready = threading.Event()
        self._load_exc: BaseException | None = None
        if self._params_fn is None:
            self._params_ready.set()

        self.kv = KVState(cfg, slots, cache_len, getattr(torch, cfg.dtype),
                          page_size=page_size, num_pages=num_pages,
                          device=self.device)
        self.pager = self.kv.pager
        self.pages_per_slot = self.kv.pages_per_slot
        self.prefix = (PrefixCache(self.pager, page_size)
                       if self._use_prefix else None)
        self.gather = (make_prefix_gather_step(cfg, cache_len=cache_len,
                                               page_size=page_size)
                       if self.prefix is not None else None)
        # orders every read (gather) and write (insert, tick) of the pool
        # on the stream
        self._pool_lock = threading.Lock()
        self._tokens = self.kv.to_dev(np.zeros((slots, 1), np.int32))
        self._active = np.zeros((slots,), bool)
        self._active_dev = self.kv.to_dev(self._active)
        self._slot_req: list[Request | None] = [None] * slots
        self._blocked_head = None
        self._inserts: collections.deque = collections.deque()
        self._lock = threading.Lock()          # inserts/counters only
        self._pending_prefills = 0
        self._intake_done = False
        self._work = threading.Event()         # decode-driver doorbell
        self._started = False
        self._h_intake = self._h_decode = None

        self._n_completed = 0
        self._tokens_out = 0
        self._lat_samples: collections.deque = collections.deque(
            maxlen=4096)
        self._ttft_samples: collections.deque = collections.deque(
            maxlen=4096)
        self._tick_intervals: collections.deque = collections.deque(
            maxlen=65536)
        self._last_tick_t: float | None = None
        self.stats_ticks = 0
        self.stats_occupancy_sum = 0.0
        self.stats_decode_tokens = 0
        self.stats_max_live_slots = 0
        self.stats_prefill_calls = 0
        self.stats_prefill_reqs = 0
        self.stats_prefill_chunks = 0
        self.stats_prefill_chunk_tasks = 0
        self.stats_stopped_early = 0
        self.stats_admission_blocks = 0
        self.stats_decode_dispatches = 0
        self.stats_prefix_hits = 0
        self.stats_prefix_tokens_saved = 0
        self.stats_cow_forks = 0

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self._started:
            raise RuntimeError("engine already started")
        self._started = True
        if self._params_fn is not None:
            self.rt.submit(self._load_params, name="serve.weights")
        self._h_intake = self.rt.submit(self._intake, name="serve.intake")
        self._h_decode = self.rt.submit(self._decode_loop,
                                        name="serve.decode")
        return self

    def submit(self, req: Request):
        self.queue.put(req)

    def close(self):
        """No more submissions; queued/in-flight requests still finish."""
        self.queue.close()

    def join(self):
        """Wait for intake + decode to drain (call after :meth:`close`)."""
        if self._h_intake is not None:
            self._h_intake.wait()
        if self._h_decode is not None:
            self._h_decode.wait()
        self.rt.wait_all()

    def shutdown(self):
        self.close()
        if self._started:
            self.join()
        if self._own_rt:
            self.rt.shutdown()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    # ------------------------------------------------------------ the tasks
    def _load_params(self):
        try:
            self._params = self._params_fn()
        except BaseException as e:     # noqa: BLE001 — re-raised by prefill
            self._load_exc = e
            raise
        finally:
            self._params_ready.set()   # hang-proof: waiters always released
            self._work.set()

    def _intake(self):
        while True:
            batch = self.queue.get_batch(
                self.policy.prefill_batch_cap(self))
            if batch is None:
                break
            with self._lock:
                self._pending_prefills += len(batch)
            self.rt.submit(self._prefill_round, batch,
                           name=f"serve.prefill:{batch[0].rid}"
                                f"x{len(batch)}")
        with self._lock:
            self._intake_done = True
        self._work.set()

    def _validate(self, req: Request):
        """Admission-impossible geometry fails loudly at prefill time."""
        if req.patches is not None:
            return NotImplementedError(
                f"request {req.rid}: vision patches are not ported yet "
                "(ROADMAP.md queue 1, item 7)")
        req.total_len = int(np.asarray(req.prefill_tokens).shape[0])
        ticks = req.max_new - max(len(req.out_tokens), 1)
        if req.total_len + ticks + 1 > self.cache_len:
            return ValueError(
                f"request {req.rid}: prompt {req.total_len} + "
                f"{ticks + 1} tokens to go exceeds cache_len "
                f"{self.cache_len}")
        if self.paged:
            need = self.pager.pages_for(req.total_len + ticks)
            if need > self.pager.capacity:
                return ValueError(
                    f"request {req.rid}: needs {need} KV pages but the "
                    f"pool only has {self.pager.capacity} — it can never "
                    "be admitted")
        return None

    def _drop_prefix_hold(self, req: Request):
        """Release the pager holds a request's prefix match still carries
        (failure and finish paths where no admission adopted them; a
        no-op once one did)."""
        if req.prefix_hold is not None and self.prefix is not None:
            self.prefix.release(req.prefix_hold)
            req.prefix_hold = None

    def _finish_failed(self, req: Request, exc: BaseException):
        self._drop_prefix_hold(req)
        if not req.done.is_set():
            req.error = exc
            req.t_done = time.monotonic()
            req.done.set()
        with self._lock:
            self._pending_prefills -= 1
        self._work.set()

    def _prefill_round(self, reqs):
        """One coalesced prefill round: validate, group by prompt shape,
        one batched prefill per group, rows queued for insertion."""
        remaining = list(reqs)
        try:
            io.wait(self._params_ready)
            if self._load_exc is not None:
                raise RuntimeError("weights load failed") \
                    from self._load_exc
            groups: dict = {}
            for req in reqs:
                err = self._validate(req)
                if err is not None:
                    remaining.remove(req)
                    self._finish_failed(req, err)
                else:
                    key = np.asarray(req.prefill_tokens).shape
                    groups.setdefault(key, []).append(req)
            exc0 = None
            for grp in groups.values():
                try:
                    self._prefill_group(grp, remaining)
                except BaseException as e:      # noqa: BLE001
                    for r in grp:
                        if r in remaining:
                            remaining.remove(r)
                            self._finish_failed(r, e)
                    if exc0 is None:
                        exc0 = e
            if exc0 is not None:
                raise exc0
        except BaseException as e:              # noqa: BLE001
            for r in remaining:
                self._finish_failed(r, e)
            remaining.clear()
            raise
        finally:
            self._work.set()

    def _prefill_group(self, grp, remaining):
        """Batched prefill of same-shape prompts, the batch padded to the
        next power of two (repeating the last row; rows are independent,
        so padding cannot perturb the real ones).  Prefix-cache hits leave
        the group first, each for its own tail-only chunk chain; a group
        the policy chunks is handed to a chunk chain (one task per chunk,
        :meth:`_prefill_chunk_task`), which owns its accounting from then
        on."""
        if self.prefix is not None:
            grp = [r for r in grp
                   if not self._try_prefix_prefill(r, remaining)]
            if not grp:
                return
        bg = len(grp)
        toks = np.stack([np.asarray(r.prefill_tokens) for r in grp])
        bpad = 1 << (bg - 1).bit_length()
        if bpad > bg:
            toks = np.concatenate(
                [toks, np.repeat(toks[-1:], bpad - bg, axis=0)])
        tj = self.kv.to_dev(toks)
        chunk = (self.policy.chunk_len(self, grp[0].total_len)
                 if self.chunk is not None else None)
        if chunk is not None:
            rows = init_cache(self.cfg, bpad, self.cache_len,
                              getattr(torch, self.cfg.dtype), self.device)
            for r in grp:
                remaining.remove(r)
            self._start_chain(grp, tj, rows, 0, int(chunk),
                              f"serve.prefill.chunk:{grp[0].rid}@0")
            return
        rows_cache, logits = self.prefill(self._params, tj)
        self._account_prefilled(grp, remaining, rows_cache, logits)

    def _start_chain(self, grp, tj, rows_cache, c0, chunk, name):
        st = {"rows_cache": rows_cache, "c0": c0, "chunks": 0,
              "chunk": chunk, "unaccounted": list(grp)}
        try:
            self.rt.submit(self._prefill_chunk_task, grp, tj, st, name=name)
        except BaseException as e:          # noqa: BLE001
            for r in st["unaccounted"]:     # the chain never started
                self._finish_failed(r, e)
            raise

    def _try_prefix_prefill(self, req, remaining) -> bool:
        """Prefix-cache hit path: match the prompt's longest cached
        prefix (full pages, plus a partial run into the divergence page:
        the copy-on-write fork source), gather the matched pages into a
        fresh batch-1 row cache, then chunk-prefill only the uncached
        tail from the divergence position.  The fork source is never
        written: the admitted slot's own fresh page receives the copy at
        insert.  Returns True when the request took this path (its chunk
        chain owns its accounting from then on)."""
        toks = np.asarray(req.prefill_tokens)
        plen = len(toks)
        if plen < 2 or self.chunk is None:
            return False
        # at most plen - 1: the last position is always recomputed (the
        # tail's last chunk makes the first token's logits)
        m = self.prefix.match_and_lock(toks, plen - 1)
        if m.tokens == 0:
            return False
        try:
            kv = self.kv
            trow = np.full((self.pages_per_slot,), GARBAGE_PAGE, np.int32)
            trow[:len(m.pages)] = m.pages
            if m.fork_src is not None:
                trow[len(m.pages)] = m.fork_src
            trow_dev = kv.to_dev(trow)
            # enqueued under the pool lock: before any later insert or
            # tick that writes these pages (one stream, in order), so
            # the fork's hold can drop as soon as the read is queued
            with self._pool_lock:
                rows_cache = self.gather(kv.cache, trow_dev, m.tokens)
            self.prefix.release_fork(m)
            req.prefix_hold = m
            with self._lock:
                self.stats_prefix_hits += 1
                self.stats_prefix_tokens_saved += m.tokens
                if m.fork_len:
                    self.stats_cow_forks += 1
        except BaseException:                   # noqa: BLE001
            self.prefix.release(m)
            raise
        remaining.remove(req)
        self._start_chain([req], kv.to_dev(toks[None]), rows_cache,
                          m.tokens, int(self.restore_chunk),
                          f"serve.prefill.hit:{req.rid}@{m.tokens}")
        return True

    def _prefill_chunk_task(self, grp, tj, st):
        """One cache-append chunk of a chunked prefill, re-submitted as a
        continuation task per chunk: concurrent long rounds interleave
        chunk by chunk on a saturated pool, where a loop inside one task
        would hold its worker for the whole prefill.  The chain owns the
        group's failure accounting."""
        try:
            plen = tj.shape[1]
            c, c0 = st["chunk"], st["c0"]
            c1 = min(c0 + c, plen)
            # extent bucket, a multiple of the chunk: attention work stays
            # at the one-shot level; non-final chunks skip the LM head
            ext = min(self.cache_len, -(-c1 // c) * c)
            rows_cache, logits = self.chunk(
                self._params, st["rows_cache"], tj[:, c0:c1], c0,
                attn_extent=ext, want_logits=c1 >= plen)
            st.update(rows_cache=rows_cache, c0=c1, chunks=st["chunks"] + 1)
            # the chunk completes before the next one is queued: chunks
            # queued back to back would hold the device like one long
            # prefill, and the gap is where decode ticks interleave
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            with self._lock:
                self.stats_prefill_chunk_tasks += 1
            if c1 < plen:
                self.rt.submit(self._prefill_chunk_task, grp, tj, st,
                               name=f"serve.prefill.chunk:{grp[0].rid}"
                                    f"@{c1}")
                return
            with self._lock:            # rounds run on concurrent workers
                self.stats_prefill_chunks += st["chunks"]
            self._account_prefilled(grp, st["unaccounted"], rows_cache,
                                    logits)
        except BaseException as e:              # noqa: BLE001
            for r in list(st["unaccounted"]):
                self._finish_failed(r, e)
            st["unaccounted"] = []
            raise
        finally:
            self._work.set()

    def _account_prefilled(self, grp, remaining, rows_cache, logits):
        """Stamp TTFT, emit the prefill token, finish done-at-prefill
        requests, queue the rest for insertion."""
        t0 = logits.argmax(dim=-1).int()
        # force the first token before stamping TTFT
        t0_host = t0.cpu().numpy()
        now = time.monotonic()
        with self._lock:
            self.stats_prefill_calls += 1
            self.stats_prefill_reqs += len(grp)
        for i, r in enumerate(grp):
            remaining.remove(r)
            r.t_first = now
            first = t0_host[i, 0]
            if r.needs_host_tokens:
                first = int(first)
            r.out_tokens.append(first)
            stopped = r.needs_host_tokens and self._hit_stop(r)
            if stopped or r.max_new == 1:   # done straight from prefill
                r.stopped = stopped and r.max_new > 1
                if r.stopped:
                    with self._lock:
                        self.stats_stopped_early += 1
                self._finish(r)
                with self._lock:
                    self._pending_prefills -= 1
            else:
                # the decrement shares the lock with the append, so the
                # decode driver never sees "drained" while a row is on its
                # way to a slot
                with self._lock:
                    self._inserts.append((r, rows_cache, i, t0))
                    self._pending_prefills -= 1
        self._work.set()

    @staticmethod
    def _hit_stop(req: Request, n_new: int = 1) -> bool:
        """Early-stop check over the newly committed positions of the
        host-visible stream; truncates ``out_tokens`` at the first match."""
        out = req.out_tokens
        for i in range(len(out) - n_new, len(out)):
            if req.eos_id is not None and out[i] == req.eos_id:
                del out[i + 1:]
                return True
            for s in req.stop or ():
                if i + 1 >= len(s) and out[i + 1 - len(s):i + 1] == s:
                    del out[i + 1:]
                    return True
        return False

    def _materialise_tokens(self, req: Request):
        """Host-ify the request's emitted stream with one device->host
        copy.  ``out_tokens`` holds the whole per-tick token tensor for
        each decoded token (tick tensors are never written after they are
        made); the slot's entry is sliced out here."""
        out = req.out_tokens
        idx = [i for i, t in enumerate(out) if isinstance(t, torch.Tensor)]
        if idx:
            vals = torch.stack([out[i] for i in idx])[:, req.slot, 0]
            vals = vals.cpu().numpy()
            for j, i in enumerate(idx):
                out[i] = vals[j]

    def _finish(self, req: Request):
        """Complete a request inline; the response write, when a sink is
        configured, is its own UMT task."""
        self._drop_prefix_hold(req)
        self._materialise_tokens(req)
        req.t_done = time.monotonic()
        with self._lock:
            self._n_completed += 1
            self._tokens_out += len(req.out_tokens)
            self._lat_samples.append(req.latency)
            self._ttft_samples.append(req.ttft)
        req.done.set()
        if self.response_sink is not None:
            self.rt.submit(self._respond, req,
                           name=f"serve.respond:{req.rid}")

    def _respond(self, req: Request):
        io.call(self.response_sink, req)      # monitored response write

    # ------------------------------------------------------- decode driver
    def _rebind_active(self):
        self._active_dev = self.kv.to_dev(self._active)

    def _do_inserts(self):
        """Admit prefilled rows into free slots, strictly head-first.
        Paged: the head reserves its worst-case pages (a prefix hit only
        those past its shared prefix pages); if the pool cannot cover them
        admission *blocks* (nothing is written) until a completion frees
        pages."""
        while True:
            free = np.flatnonzero(~self._active)
            if len(free) == 0:
                return
            with self._lock:
                if not self._inserts:
                    return
                req, rows_cache, row, t0 = self._inserts[0]
            ids = None
            shared: list[int] = []
            if self.paged:
                if req.prefix_hold is not None:
                    shared = list(req.prefix_hold.pages)
                need = self.pager.pages_for(
                    self.policy.admission_tokens(self, req))
                ids = self._alloc_pages(need - len(shared))
                if ids is None and self._drop_queued_holds():
                    shared = []
                    ids = self._alloc_pages(need)
                if ids is None:         # admission blocked on free pages
                    if self._blocked_head != req.rid:
                        self._blocked_head = req.rid
                        self.stats_admission_blocks += 1
                    return
            self._blocked_head = None
            with self._lock:
                self._inserts.popleft()
            s = int(self.policy.select_slot(self, free))
            if self._active[s]:
                raise RuntimeError(f"policy picked live slot {s}")
            kv = self.kv
            with self._pool_lock:
                if self.paged:
                    req.pages = shared + ids
                    req.prefix_hold = None  # the holds are the slot's now
                    table_row = kv.bind_slot_pages(s, req.pages,
                                                   n_shared=len(shared))
                    new_cache = self.insert(kv.cache, rows_cache, row, s,
                                            table_row)
                else:
                    new_cache = self.insert(kv.cache, rows_cache, row, s)
                kv.commit(new_cache)
            # a new tensor, never an in-place write: earlier tick tensors
            # are held by requests' out_tokens
            tokens = self._tokens.clone()
            tokens[s] = t0[row]
            self._tokens = tokens
            self._active[s] = True
            self._rebind_active()
            self._slot_req[s] = req
            req.slot = s
            # the prompt's full pages become reusable: their insert is
            # queued above, before any gather a later match enqueues
            if self.prefix is not None and req.total_len >= self.page_size:
                self.prefix.insert(req.tokens, req.pages, req.total_len)

    def _drop_queued_holds(self) -> bool:
        """A blocked head holds nothing, and neither do the rows queued
        behind it: with no slot live, their holds could pin the very
        pages the head waits for.  Each falls back to all-fresh pages at
        admission (its gathered row holds the whole prefix: only the
        sharing is lost).  Returns whether any hold was dropped."""
        with self._lock:
            held = [q for q, *_ in self._inserts if q.prefix_hold]
        for q in held:
            self._drop_prefix_hold(q)
        return bool(held)

    def _alloc_pages(self, n: int):
        """Allocate ``n`` pages; on a shortfall the policy first reclaims
        idle prefix-cache pages (refcount-0 trie leaves)."""
        if n <= 0:
            return []
        got = self.pager.alloc(n)
        if got is None and self.prefix is not None:
            deficit = n - self.pager.free_pages
            if deficit > 0:
                self.policy.prefix_evict(self, deficit)
            got = self.pager.alloc(n)
        return got

    def _prefix_insert_slot(self, req: Request):
        """Adopt a finished slot's complete pages into the trie, keyed on
        prompt + generated minus the last token: exactly the written
        cache extent."""
        if self.prefix is None or not req.pages:
            return
        toks = np.asarray(req.tokens)
        gen = req.out_tokens[:-1]
        key = toks if not gen else np.concatenate(
            [toks, np.asarray(gen).reshape((len(gen),) + toks.shape[1:])])
        if len(key) >= self.page_size:
            self.prefix.insert(key, req.pages, len(key))

    def _release_slot(self, s: int):
        """Free a slot and its pages now; its table row is re-pointed at
        the garbage page."""
        req = self._slot_req[s]
        self._active[s] = False
        self._slot_req[s] = None
        if self.paged and req.pages is not None:
            self.kv.release_slot_pages(s)
            self.pager.release(req.pages)
            req.pages = None

    def _tick(self):
        kv = self.kv
        with self._pool_lock:
            if self.paged:
                new_tokens, new_cache = self.decode(
                    self._params, kv.cache, self._tokens, self._active_dev,
                    kv.table_dev)
            else:
                new_tokens, new_cache = self.decode(
                    self._params, kv.cache, self._tokens, self._active_dev)
            kv.commit(new_cache)
        self.stats_decode_dispatches += 1
        self._tokens = new_tokens
        if self.sync_ticks and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.monotonic()
        if self._last_tick_t is not None:
            with self._lock:    # stats() iterates this deque concurrently
                self._tick_intervals.append(now - self._last_tick_t)
        self._last_tick_t = now
        live = np.flatnonzero(self._active)
        n_live = len(live)
        self.stats_ticks += 1
        self.stats_decode_tokens += n_live
        self.stats_occupancy_sum += n_live / self.slots
        if n_live > self.stats_max_live_slots:
            self.stats_max_live_slots = n_live
        host_toks = None
        if any(self._slot_req[s].needs_host_tokens for s in live):
            host_toks = self._tokens.cpu().numpy()   # one small sync
        freed = False
        for s in live:
            req = self._slot_req[s]
            stopped = False
            if req.needs_host_tokens:
                req.out_tokens.append(int(host_toks[s, 0]))
                stopped = self._hit_stop(req)
            else:
                req.out_tokens.append(self._tokens)  # whole tick tensor
            if stopped or len(req.out_tokens) >= req.max_new:
                req.stopped = stopped and len(req.out_tokens) < req.max_new
                if req.stopped:
                    with self._lock:
                        self.stats_stopped_early += 1
                # finish FIRST: its device->host copy drains everything
                # queued so far, so nothing pending reads the pages freed
                # next
                self._finish(req)
                self._prefix_insert_slot(req)   # pages -> reuse capital
                self._release_slot(s)
                freed = True
        if freed:
            self._rebind_active()
            if self.paged:
                self.kv.sync_table()

    def _drained(self) -> bool:
        with self._lock:
            return (self._intake_done and not self._inserts
                    and self._pending_prefills == 0)

    def _decode_loop(self):
        while True:
            self._do_inserts()
            if self._active.any():
                self._tick()
                continue
            self._last_tick_t = None     # idle gap: not tick jitter
            if self._drained():
                break
            self._work.clear()
            with self._lock:
                pending = bool(self._inserts)
            if pending:
                continue
            # nothing live: a monitored wait frees this core for prefill /
            # weights / intake work
            io.wait(self._work, self.idle_wait)

    # ------------------------------------------------------------ reporting
    def stats(self) -> dict:
        """The reference's key set; features outside this slice report as
        off or 0."""
        with self._lock:
            n = self._n_completed
            tokens_out = self._tokens_out
            lats = sorted(self._lat_samples)
            ttfts = sorted(self._ttft_samples)
            ticks = sorted(self._tick_intervals)
        out = {
            "requests": n,
            "slots": self.slots,
            "ticks": self.stats_ticks,
            "decode_tokens": self.stats_decode_tokens,
            "tokens_out": tokens_out,
            "occupancy": (self.stats_occupancy_sum / self.stats_ticks
                          if self.stats_ticks else 0.0),
            "max_live_slots": self.stats_max_live_slots,
            "prefill_calls": self.stats_prefill_calls,
            "prefill_reqs": self.stats_prefill_reqs,
            "prefill_chunks": self.stats_prefill_chunks,
            "prefill_chunk_tasks": self.stats_prefill_chunk_tasks,
            "stopped_early": self.stats_stopped_early,
            "admission_blocks": self.stats_admission_blocks,
            "evictions": 0,
            "restores": 0,
            "pages_grown": 0,
            "pages_grown_multi": 0,
            "decode_dispatches": self.stats_decode_dispatches,
            "dispatches_per_token": (
                self.stats_decode_dispatches
                / max(self.stats_decode_tokens, 1)),
            "spec": "off",
            "spec_k": 0,
            "spec_drafted": 0,
            "spec_accepted": 0,
            "spec_rollbacks": 0,
            "spec_accept_rate": 0.0,
            "prefix_cache": self.prefix is not None,
            "prefix_hits": self.stats_prefix_hits,
            "prefix_tokens_saved": self.stats_prefix_tokens_saved,
            "cow_forks": self.stats_cow_forks,
            "policy": self.policy.name,
            "donate": self.donate,
            "paged_kernel": self.paged_kernel,
            "tp": False,
            "p50_latency_s": percentile(lats, 0.50),
            "p99_latency_s": percentile(lats, 0.99),
            "p50_ttft_s": percentile(ttfts, 0.50),
            "p99_ttft_s": percentile(ttfts, 0.99),
            "p50_tick_s": percentile(ticks, 0.50),
            "p99_tick_s": percentile(ticks, 0.99),
            "page_size": self.page_size,
        }
        out.update(self.kv.stats())     # versions, commits, pager pool
        if self.prefix is not None:
            out.update(self.prefix.stats())
        return out


__all__ = ["ServeEngine", "auto_page_size", "percentile"]
