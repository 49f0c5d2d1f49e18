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

On-demand paging (``policy="ondemand"``): admission reserves only the
prefill extent; before each tick the fault pass grows a slot's block
table page by page as its write position crosses a page boundary, and
when the pool is dry the policy names a victim, which is evicted (its
tokens brought to the host, its written pages handed to the trie, its
slot and pages freed) and resubmitted as a restore.  A restore replays
prompt + generated[:-1] through the chunk step where prefill chunks
exactly (prefill-replay), or re-prefills the prompt and feeds the
recorded tokens through the serve step (decode-replay: SSD, sliding-window
rings, MoE), then re-enters admission at the head of the queue.

Speculative decoding (``spec="ngram"``, or any mode the policy's
``spec_drafter`` resolves): every tick drafts up to ``spec_k`` tokens per
live slot from the slot's own stream (:mod:`.spec`), verifies the whole
pool's windows in one dispatch (``steps.make_verify_step``, always
``spec_k + 1`` lanes wide) and commits each slot's longest agreeing
draft prefix plus the model's correction, so the tokens are the verify
step's argmaxes, never drafts.  Positions are the host's
(``_slot_pos``), tokens are host ints from admission on, and the tick
reads its argmaxes to the host once.

Frontends (the reference's stubs): a vision request carries its
``patches`` (n_patches, d_model), which count toward its length, ride
its prefill (the first chunk of a chunked one or of a restore) and keep
it out of the prefix trie, since its token key lacks them; an audio
request's prompt is (P, K) codebook ids, each step emits (K,) ids (the
token buffers are (slots, 1, K)), and eos/stop and speculation are
refused, as in the reference.

Tensor parallelism (``mesh=``, a ``launch.mesh.Mesh`` whose model axis
is above 1; ``tp=None`` turns it on exactly then): weights and pool are
sharded on heads and feed-forward width (``steps.TP_SERVE_RULES``), this
process is rank 0 and every step the engine issues — prefill, batched
insert, decode (gather path and paged kernel), prefill chunk, prefix
gather, verify, restore replay, the pool and row caches themselves —
runs on every rank through one :class:`.tp.Session`, in one order under
its lock.  Block tables, positions, tokens and logits stay whole; every
host-side decision stays here.  ``shutdown`` ends the followers' session
and waits for them; the mesh (its processes) is the caller's.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from ..core import UMTRuntime, io
from ..device import resolve_device
from ..steps import (check_tp, chunkable, make_batched_insert_step,
                     make_decode_step, make_pool_step,
                     make_prefill_chunk_step, make_prefill_step,
                     make_prefix_gather_step, make_row_cache_step,
                     make_serve_step, make_verify_step, speculatable)
from .kvstate import KVState
from .pager import GARBAGE_PAGE
from .policy import SchedulerPolicy, SlotView, make_policy
from .prefix import PrefixCache
from .request import Request, RequestQueue
from .tp import Session


# keys of ``ServeEngine.stats()`` that the reference's engine does not have
PORT_ONLY_STATS = ("restore_divergences",)


def percentile(xs, q):
    """Nearest-rank percentile of a pre-sorted list (None when empty)."""
    return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else None


def auto_page_size(cache_len: int, cap: int = 8) -> int:
    """Largest divisor of ``cache_len`` that is <= ``cap``."""
    return max(d for d in range(1, min(cap, cache_len) + 1)
               if cache_len % d == 0)


def accept_window(draft, argmax):
    """Greedy acceptance of one slot's verify window.  Lane j's argmax is
    the token decode emits after lanes 0..j, and draft j sits in lane j +
    1, so the drafts are accepted while each equals the argmax of the lane
    before it: the longest agreeing prefix, ``m`` drafts.  The committed
    tokens are the argmaxes of lanes 0..m (the accepted drafts' values,
    then the model's correction), never the drafts themselves.  Returns
    (m, committed tokens)."""
    m = 0
    while m < len(draft) and int(argmax[m]) == draft[m]:
        m += 1
    return m, [int(argmax[j]) for j in range(m + 1)]


class ServeEngine:
    """Continuous-batching engine over one model + one slot pool.

    Parameters mirror ``repro.serve.ServeEngine``; ``device`` (default
    ``"cuda"``) places the weights' consumers, the pool and every step.
    ``params`` is a weights tree already on ``device`` or a zero-arg
    callable returning one (run as the weights task).  ``donate`` is
    accepted for parity: the pool is always updated in place.  ``spec``
    (None/"off", "ngram", "ngram:max,min", or a mode the policy's
    ``spec_drafter`` knows) turns on speculative decoding with windows of
    up to ``spec_k`` drafted tokens; a config that ``speculatable``
    refuses raises ``ValueError``.  A tick that fails on the device fails
    every live request with its error; there is no fallback to another
    tick or to the CPU.

    Deviation of the restore check: the reference asserts that a restore
    re-derives every emitted token exactly.  With ``strict_restore`` (the
    default on the CPU, where the port runs in f32 as the reference's
    tests do) the port asserts the same.  On the card, in bf16, a restore
    recomputes positions through other kernels than the ticks did (the
    chunk step's plain attention, or a batch-1 serve step), and a near-tie
    can flip; there the mismatch is recorded in ``restore_divergences``
    (rid, token index, emitted, re-derived) and counted in ``stats()``,
    and the restore feeds the *emitted* token on, so the stream stays the
    one the caller saw.

    Tensor parallelism: ``mesh`` with a model axis above 1 (``tp=None``
    turns it on exactly then; ``tp=True`` without a mesh raises, and so
    does ``tp=False`` on such a mesh, whose ranks would sit idle).
    ``params`` is then the full tree (cut here, each follower's shard sent
    over its pipe), a zero-arg callable returning it (the weights task),
    or a per-rank factory such as ``serve.tp.SeededParams`` (each rank
    makes its own shard).  Raises ``NotImplementedError`` where the config
    is not ported under a mesh (``steps.check_tp``).
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
        # tensor-parallel serving turns on exactly when the mesh has a
        # model axis to shard over (the reference's rule)
        model = 1 if mesh is None else mesh.shape.get("model", 1)
        if tp is None:
            tp = model > 1
        self.tp = bool(tp)
        if self.tp and mesh is None:
            raise ValueError("tp=True needs a (data, model) mesh")
        if not self.tp and model > 1:
            raise ValueError(f"tp=False on a mesh whose model axis is "
                             f"{model}: its follower ranks would sit idle")
        self.mesh = mesh
        check_tp(cfg, mesh)
        self.policy = make_policy(policy)
        self.device = resolve_device(device)
        # every step below is built, and later run, on every rank
        self._tp = Session(mesh, cfg, self.device) if self.tp else None
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
        if self.policy.on_demand and not self.paged:
            raise ValueError(
                f"policy {self.policy.name!r} is on-demand paging — it "
                "needs a paged engine (page_size is None here)")
        # only build per-tick SlotView snapshots for policies that
        # override the unforced-preemption hook (ref engine.py:441)
        self._policy_may_evict = (type(self.policy).maybe_evict
                                  is not SchedulerPolicy.maybe_evict)
        self.strict_restore = self.device.type == "cpu"
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
        self.prefill = self._make("prefill", make_prefill_step,
                                  cache_len=cache_len)
        # the chunk step serves chunked prefill and the prefix hit's tail
        self.chunk = (self._make("chunk", make_prefill_chunk_step,
                                 cache_len=cache_len)
                      if self._chunkable else None)
        self.rows = self._make("rows", make_row_cache_step,
                               cache_len=cache_len, dtype=cfg.dtype,
                               device=self.device)
        # the restore after an eviction: prefill-replay of prompt +
        # generated[:-1] through the chunk step where prefill chunks
        # exactly, decode-replay of the emitted tokens through the serve
        # step otherwise (MoE capacity, SSD chunking, SWA rings)
        self._restore_prefill = self._chunkable
        self.replay = self._make("replay", make_serve_step)
        # chunk width of a prefix hit's tail and of a prefill-replay when
        # the engine has no prefill_chunk of its own
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
        self.insert = self._make("insert", make_batched_insert_step,
                                 cache_len=cache_len, page_size=page_size)
        self.decode = self._make("decode", make_decode_step,
                                 cache_len=cache_len, page_size=page_size,
                                 paged_kernel=self.paged_kernel)
        # speculative decoding: the drafter is the policy's choice, the
        # verify step runs every tick, spec_k + 1 lanes wide
        self.spec_mode = None if spec in (None, "off") else str(spec)
        self.spec_k = int(spec_k)
        self.verify = self.drafter = None
        if self.spec_mode is not None:
            if self.spec_k < 1:
                raise ValueError(f"spec_k={spec_k}: need >= 1")
            if not speculatable(cfg, cache_len):
                raise ValueError(
                    f"{cfg.name}: speculative decoding needs a chunk-exact "
                    "config (no MoE, no SSM, no SWA ring shorter than "
                    "cache_len) and a scalar greedy-token frontend")
            self.verify = self._make("verify", make_verify_step,
                                     cache_len=cache_len,
                                     page_size=page_size)
            self.drafter = self.policy.spec_drafter(self, self.spec_mode)

        self._params = None if callable(params) else params
        self._params_fn = params if callable(params) else None
        self._params_ready = threading.Event()
        self._load_exc: BaseException | None = None
        if self._params_fn is None:
            if self._tp is not None:
                self._params = self._tp.load(params)
            self._params_ready.set()

        self.kv = KVState(cfg, slots, cache_len, getattr(torch, cfg.dtype),
                          page_size=page_size, num_pages=num_pages,
                          device=self.device,
                          pool=None if self._tp is None else self._make(
                              "pool", make_pool_step, slots=slots,
                              cache_len=cache_len, dtype=cfg.dtype,
                              page_size=page_size, device=self.device))
        self.pager = self.kv.pager
        self.pages_per_slot = self.kv.pages_per_slot
        self.prefix = (PrefixCache(self.pager, page_size)
                       if self._use_prefix else None)
        self.gather = (self._make("gather", make_prefix_gather_step,
                                  cache_len=cache_len, page_size=page_size)
                       if self.prefix is not None else None)
        # orders every read (gather) and write (insert, tick) of the pool
        # on the stream
        self._pool_lock = threading.Lock()
        # a step's token per slot: one id, or K codebook ids for audio
        self._extra = ((cfg.n_codebooks,)
                       if cfg.frontend == "audio_codebooks" else ())
        self._tokens = self.kv.to_dev(np.zeros((slots, 1) + self._extra,
                                               np.int32))
        self._active = np.zeros((slots,), bool)
        self._active_dev = self.kv.to_dev(self._active)
        self._slot_req: list[Request | None] = [None] * slots
        # what the policy decides over: the position each slot's next tick
        # writes (drives on-demand growth) and its admission sequence
        # (drives the victim order)
        self._slot_pos = np.zeros((slots,), np.int64)
        self._slot_seq = np.zeros((slots,), np.int64)
        self._admit_seq = 0
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
        self.stats_evictions = 0
        self.stats_restores = 0
        self.stats_pages_grown = 0
        self.stats_pages_grown_multi = 0
        self.restore_divergences: list = []
        self.stats_decode_dispatches = 0
        self.stats_prefix_hits = 0
        self.stats_prefix_tokens_saved = 0
        self.stats_cow_forks = 0
        self.stats_spec_drafted = 0
        self.stats_spec_accepted = 0
        self.stats_spec_rollbacks = 0

    def _make(self, key, maker, **kw):
        """Step ``key`` from ``maker``: built here, or on every rank (and
        dispatched to every rank) under tensor parallelism."""
        if self._tp is None:
            return maker(self.cfg, **kw)
        return self._tp.step(key, maker, **kw)

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
            # the task handles hold the engine's bound methods: dropped,
            # the engine (pool, weights) is freed as soon as the caller
            # drops it, not at the next cyclic garbage collection
            self._h_intake = self._h_decode = None
        if self._own_rt:
            self.rt.shutdown()
        if self._tp is not None:
            self._tp.close()            # the followers drop their state

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    # ------------------------------------------------------------ the tasks
    def _load_params(self):
        try:
            if getattr(self._params_fn, "per_rank", False) \
                    and self._tp is None:       # one rank: the whole tree
                self._params = self._params_fn(self.cfg, None, self.device)
            elif self._tp is None:
                self._params = self._params_fn()
            elif getattr(self._params_fn, "per_rank", False):
                self._params = self._tp.load(self._params_fn)
            else:
                self._params = self._tp.load(self._params_fn())
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
        """Admission-impossible geometry fails loudly at prefill time; a
        vision request's patches count toward its length."""
        p = self.cfg.n_patches \
            if self.cfg.frontend == "vision_patches" else 0
        req.total_len = int(np.asarray(req.prefill_tokens).shape[0]) + p
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
        if req.needs_host_tokens and \
                self.cfg.frontend == "audio_codebooks":
            return ValueError(
                f"request {req.rid}: eos_id/stop are not supported for "
                "audio-codebook frontends")
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
                    key = (np.asarray(req.prefill_tokens).shape,
                           req.patches is not None)
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
        so padding cannot perturb the real ones); a vision group's patches
        are stacked and padded alongside.  Prefix-cache hits leave the
        group first, each for its own tail-only chunk chain (a vision
        group never: its patches make the prompt an incomplete key); a
        group the policy chunks is handed to a chunk chain (one task per
        chunk, :meth:`_prefill_chunk_task`, the patches on its first
        chunk), which owns its accounting from then on."""
        if self.prefix is not None and grp[0].patches is None:
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
        pj = None
        if grp[0].patches is not None:   # host arrays or device tensors
            if isinstance(grp[0].patches, torch.Tensor):
                pj = torch.stack([r.patches.to(self.device) for r in grp])
            else:
                pj = self.kv.to_dev(np.stack([np.asarray(r.patches)
                                              for r in grp]))
            if bpad > bg:
                pj = torch.cat([pj, pj[-1:].expand(bpad - bg,
                                                   *pj.shape[1:])])
        if self.chunk is not None and grp[0].resume \
                and grp[0].restore_tokens is not None:
            # prefill-replay restore (ref engine.py:930-938): through the
            # chunk step at the restore width, whatever the depth
            chunk = self.restore_chunk
        else:
            chunk = (self.policy.chunk_len(self, grp[0].total_len)
                     if self.chunk is not None else None)
        if chunk is not None:
            rows = self.rows(bpad)
            for r in grp:
                remaining.remove(r)
            self._start_chain(grp, tj, rows, 0, int(chunk),
                              f"serve.prefill.chunk:{grp[0].rid}@0", pj)
            return
        rows_cache, logits = self.prefill(self._params, tj, pj)
        self._account_prefilled(grp, remaining, rows_cache, logits)

    def _start_chain(self, grp, tj, rows_cache, c0, chunk, name, pj=None):
        """``c0``: the first prompt token the chain prefills, at cache
        position ``c0`` (after a prefix hit's matched tokens); ``pj``: the
        group's patches, which ride its first chunk."""
        st = {"rows_cache": rows_cache, "c0": c0, "off": c0, "pj": pj,
              "chunks": 0, "chunk": chunk, "unaccounted": list(grp)}
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
            c, c0, off, pj = st["chunk"], st["c0"], st["off"], st["pj"]
            c1 = min(c0 + c, plen)
            # cache positions written through this chunk: the patches
            # (first chunk only) come before the prompt's tokens
            covered = off + (c1 - c0) + (0 if pj is None else pj.shape[1])
            # extent bucket, a multiple of the chunk: attention work stays
            # at the one-shot level; non-final chunks skip the LM head
            ext = min(self.cache_len, -(-covered // c) * c)
            rows_cache, logits = self.chunk(
                self._params, st["rows_cache"], tj[:, c0:c1], off, pj,
                attn_extent=ext, want_logits=c1 >= plen)
            st.update(rows_cache=rows_cache, c0=c1, off=covered, pj=None,
                      chunks=st["chunks"] + 1)
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
            if r.resume:
                # checked while still unaccounted: a restore that raises
                # fails its request (the reference's removes it first, and
                # its engine then never drains)
                self._account_restore(grp, r, t0_host[i, 0], rows_cache)
                remaining.remove(r)
                continue
            remaining.remove(r)
            r.t_first = now
            first = t0_host[i, 0]
            if r.needs_host_tokens or self.drafter is not None:
                first = int(first)      # a spec stream is host ints
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

    def _account_restore(self, grp, r: Request, t0, rows_cache):
        """A restore's prefill is done (ref engine.py:1109-1145): every
        token it replays was emitted (and stop-checked) before the
        eviction, so nothing is appended and TTFT keeps its first stamp;
        the row re-enters at the *head* of admission, so evicted requests
        outrank new arrivals."""
        if len(grp) != 1:
            raise RuntimeError("restore rounds are singleton")
        if r.restore_tokens is None:
            # decode-replay: the prefill covered the prompt only and
            # re-derived the first token; the serve step re-feeds the rest
            self._check_restore(r, 0, t0)
            rows_cache = self._replay_generated(r, rows_cache)
            r.total_len += len(r.out_tokens) - 1
        else:
            # prefill-replay: the prefill covered prompt + generated[:-1];
            # its argmax re-derives the last emitted token
            self._check_restore(r, len(r.out_tokens) - 1, t0)
        # the next tick is fed the emitted token (equal to the re-derived
        # one unless a divergence was recorded)
        tok = self.kv.to_dev(np.asarray(r.out_tokens[-1], np.int32).reshape(
            (1, 1) + self._extra))
        r.resume = False
        with self._lock:
            self.stats_restores += 1
            self._inserts.appendleft((r, rows_cache, 0, tok))
            self._pending_prefills -= 1

    def _check_restore(self, r: Request, k: int, got):
        """Token ``k`` re-derived by a restore against the emitted one:
        the reference's assertion under ``strict_restore``, else a
        recorded divergence (see the class docstring)."""
        want, got = np.asarray(r.out_tokens[k]), np.asarray(got)
        if np.array_equal(got, want):
            return
        if self.strict_restore:
            raise AssertionError(f"request {r.rid}: restore diverged from "
                                 f"the emitted stream at token {k}")
        with self._lock:
            self.restore_divergences.append((r.rid, k, want.tolist(),
                                             got.tolist()))

    def _replay_generated(self, req: Request, rows_cache):
        """Decode-replay (ref engine.py:1169-1201): re-feed the emitted
        tokens one at a time through the serve step on the freshly
        prefilled row cache, advancing it to prompt + generated[:-1] —
        the computation the ticks ran, one row wide (an audio step is fed
        its (1, 1, K) codes).  One host read for the whole chain, then
        every re-derived token is checked."""
        toks = req.out_tokens
        if len(toks) <= 1:
            return rows_cache
        cache, nxts = rows_cache, []
        for k in range(len(toks) - 1):
            fed = self.kv.to_dev(np.asarray(toks[k], np.int32).reshape(
                (1, 1) + self._extra))
            nxt, cache = self.replay(self._params, cache, fed)
            nxts.append(nxt)
        got = torch.cat(nxts).reshape((-1,) + self._extra).cpu().numpy()
        for k, g in enumerate(got):
            self._check_restore(req, k + 1, g)
        return cache

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
                head = self._inserts[0]
            req, rows_cache, row, t0 = head
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
                # the entry admitted, not whatever heads the queue now: a
                # restore's prefill round may have put itself in front
                # (``appendleft``) since the peek; popping the head would
                # drop that restore, its request never to finish, and
                # leave this one queued, to be admitted a second time
                # into another slot whose table then outgrows its pages
                k = next(i for i, e in enumerate(self._inserts)
                         if e is head)
                del self._inserts[k]
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
            self._slot_pos[s] = req.total_len   # next cache write position
            self._admit_seq += 1
            self._slot_seq[s] = self._admit_seq
            # the prompt's full pages become reusable: their insert is
            # queued above, before any gather a later match enqueues (a
            # vision prompt's key lacks its patches: never cached)
            if self.prefix is not None and req.patches is None \
                    and req.total_len >= self.page_size:
                key = (req.restore_tokens
                       if req.restore_tokens is not None else req.tokens)
                self.prefix.insert(key, req.pages, req.total_len)

    def _slot_views(self) -> list:
        """Read-only live-slot snapshots for policy decisions."""
        views = []
        for s in np.flatnonzero(self._active):
            s = int(s)
            req = self._slot_req[s]
            views.append(SlotView(
                slot=s, rid=req.rid, admit_seq=int(self._slot_seq[s]),
                pages_held=len(req.pages) if req.pages else 0,
                next_pos=int(self._slot_pos[s]),
                emitted=len(req.out_tokens), budget=req.max_new))
        return views

    def _evict_slot(self, s: int):
        """Preempt live slot ``s`` (ref engine.py:1407-1435; *which* slot
        is the policy's call): bring its tokens to the host, hand its
        written pages to the trie, free the slot and its pages, and
        resubmit the request as a restore.  Finish before free: the
        device->host copy of the tokens drains the stream first, and any
        later write of a freed page is queued behind everything that read
        it.  The caller refreshes the active mask and block table after
        its batch of evictions."""
        req = self._slot_req[s]
        self._materialise_tokens(req)
        req.build_restore(self._restore_prefill)
        self._prefix_insert_slot(req)   # restores re-hit these pages
        self._release_slot(s)
        self.stats_evictions += 1
        with self._lock:
            self._pending_prefills += 1
        self.rt.submit(self._prefill_round, [req],
                       name=f"serve.restore:{req.rid}"
                            f"@{len(req.out_tokens)}")

    def _page_faults(self, ahead=None):
        """On-demand growth (ref engine.py:1469-1524): a live slot whose
        last write position this tick lies past its pages grows one page
        at a time, oldest slot first (the default victim spares the
        oldest, so the head of the line grows before younger slots take
        the pages it needs).  ``ahead`` ((slots,) ints, speculative
        decoding): the tick writes positions up to ``_slot_pos[s] +
        ahead[s]``, which can cross several page boundaries in one tick.
        A dry pool is a block the policy resolves by naming a victim to
        evict.  Under worst-case reservation nothing ever faults (the
        window is clamped to the request's budget): one comparison per
        live slot."""
        grown = evicted = False
        ps = self.page_size
        order = sorted(np.flatnonzero(self._active),
                       key=lambda x: self._slot_seq[x])
        for s in order:
            s = int(s)
            if not self._active[s]:     # evicted as a victim this pass
                continue
            req = self._slot_req[s]
            need = self._slot_pos[s] + (0 if ahead is None else ahead[s])
            grown_here = 0
            while self._active[s] and len(req.pages) * ps <= need:
                got = self._alloc_pages(1)
                if got is not None:
                    self.kv.grow_slot_pages(s, got, base=len(req.pages))
                    req.pages.extend(got)
                    self.stats_pages_grown += 1
                    grown_here += 1
                    grown = True
                    continue
                victim = self.policy.select_victim(
                    self, self._slot_views(), needy=s)
                if victim is None or not self._active[int(victim)]:
                    raise RuntimeError(
                        f"policy {self.policy.name!r} returned no live "
                        f"victim for page-starved slot {s} — eviction is "
                        "the only unblock for an on-demand fault")
                self._evict_slot(int(victim))
                evicted = True
            if grown_here > 1:
                self.stats_pages_grown_multi += 1
            if not self._active.any():
                break
        if grown or evicted:
            self.kv.sync_table()
        if evicted:
            self._rebind_active()

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
        cache extent.  Never a vision request's (its key lacks the
        patches)."""
        if self.prefix is None or req.patches is not None or not req.pages:
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

    def _maybe_preempt(self):
        """The policy's unforced preemption before a dispatch (ref
        engine.py:1541-1556); the on-demand fault pass follows it."""
        if self._policy_may_evict:
            v = self.policy.maybe_evict(self, self._slot_views())
            if v is not None:
                self._evict_slot(int(v))
                self._after_frees()

    def _record_tick(self, n_live: int):
        now = time.monotonic()
        if self._last_tick_t is not None:
            with self._lock:    # stats() iterates this deque concurrently
                self._tick_intervals.append(now - self._last_tick_t)
        self._last_tick_t = now
        self.stats_ticks += 1
        self.stats_occupancy_sum += n_live / self.slots
        self.stats_max_live_slots = max(self.stats_max_live_slots, n_live)

    def _end_if_done(self, s: int, stopped: bool) -> bool:
        """Finish slot ``s``'s request when it stopped or ran out of
        budget, then free the slot; returns whether it did.  Finish
        FIRST: its device->host copy drains everything queued so far, so
        nothing pending reads the pages freed next."""
        req = self._slot_req[s]
        if not (stopped or len(req.out_tokens) >= req.max_new):
            return False
        req.stopped = stopped and len(req.out_tokens) < req.max_new
        if req.stopped:
            with self._lock:
                self.stats_stopped_early += 1
        self._finish(req)
        self._prefix_insert_slot(req)       # pages -> reuse capital
        self._release_slot(s)
        return True

    def _after_frees(self):
        """Publish freed slots: the active mask, and the block table."""
        self._rebind_active()
        if self.paged:
            self.kv.sync_table()

    def _tick(self):
        kv = self.kv
        # pre-dispatch policy window: unforced preemption, then on-demand
        # page faults; both may evict, and the tick runs over whatever is
        # still live
        self._maybe_preempt()
        if self.paged:
            self._page_faults()
        if not self._active.any():
            return                      # everything evicted: no tick
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
        self._slot_pos[self._active] += 1   # each live slot wrote one pos
        if self.sync_ticks and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        live = np.flatnonzero(self._active)
        self._record_tick(len(live))
        self.stats_decode_tokens += len(live)
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
            freed |= self._end_if_done(int(s), stopped)
        if freed:
            self._after_frees()

    def _spec_window(self, req: Request) -> list[int]:
        """Drafts for one live slot (ref engine.py:1633-1648): the policy
        says how many, the drafter proposes, the engine clamps to
        ``spec_k`` and to the request's remaining budget, so a window
        never writes a position the plain run would not."""
        k = min(int(self.policy.spec_draft_k(self, req)), self.spec_k,
                req.max_new - len(req.out_tokens) - 1)
        if k <= 0:
            return []
        ctx = np.asarray(req.tokens).reshape(-1).tolist() \
            + [int(t) for t in req.out_tokens]
        return [int(d) for d in self.drafter.draft(ctx, k)[:k]]

    def _check_window_private(self, live, drafts):
        """Under the prefix cache every page a verify window writes must be
        the slot's own: allocated, held once, not in the trie."""
        kv, ps = self.kv, self.page_size
        for s in live:
            last = self._slot_pos[s] + len(drafts.get(s, ()))
            for lp in range(int(self._slot_pos[s]) // ps, int(last) // ps + 1):
                pid = int(kv._table[s, lp])
                if (pid == GARBAGE_PAGE or self.pager.refcount(pid) != 1
                        or self.pager.is_cached(pid)):
                    raise RuntimeError(f"slot {s} would verify-write shared "
                                       f"or cached page {pid}")

    def _tick_spec(self):
        """One speculative tick (ref engine.py:1650-1784): draft per slot,
        verify every live slot's window in ONE dispatch, commit each
        slot's longest agreeing prefix plus the correction, scan stops
        inside the window.  Every tick goes through the verify step, a
        tick with no draft too: the decode step's device-side ``pos + 1``
        would go stale, since positions advance by what each slot
        commits.  One host read of the argmaxes per tick.

        Deviation: every dispatch has the one width ``spec_k + 1`` (a
        slot that drafted less has masked lanes), where the reference
        narrows a tick in which nobody drafted to S=1.  So a slot's
        tokens never depend on whether its neighbours drafted in that
        tick: on an H100 the GEMMs of 16 rows and of 80 round
        differently (the MLP's down projection), which flips near-tied
        argmaxes between the two widths (``chip_smoke.py``'s "verify
        alone" counts them).  A tick with no draft pays for the full
        width."""
        kv = self.kv
        self._maybe_preempt()
        # draft before the fault pass: growth must cover the whole window
        drafts = {}
        for s in np.flatnonzero(self._active):
            d = self._spec_window(self._slot_req[int(s)])
            if d:
                drafts[int(s)] = d
        if self.paged:
            ahead = np.zeros((self.slots,), np.int64)
            for s, d in drafts.items():
                ahead[s] = len(d)
            self._page_faults(ahead=ahead)
            # the fault pass may have evicted a drafted slot
            drafts = {s: d for s, d in drafts.items() if self._active[s]}
        if not self._active.any():
            return                      # everything evicted: no tick
        live = [int(s) for s in np.flatnonzero(self._active)]
        if self.prefix is not None:
            self._check_window_private(live, drafts)
        toks = np.zeros((self.slots, 1 + self.spec_k), np.int32)
        n_tok = np.zeros((self.slots,), np.int32)       # 0: a dead slot
        for s in live:
            win = [int(self._slot_req[s].out_tokens[-1])] + drafts.get(s, [])
            toks[s, :len(win)] = win
            n_tok[s] = len(win)
        with self._pool_lock:
            args = (self._params, kv.cache, kv.to_dev(toks),
                    kv.to_dev(self._slot_pos.astype(np.int32)),
                    kv.to_dev(n_tok))
            if self.paged:
                args += (kv.table_dev,)
            nxt, new_cache = self.verify(*args)
            kv.commit(new_cache)
        self.stats_decode_dispatches += 1
        host_nxt = nxt.cpu().numpy()    # the tick's one host sync
        self._record_tick(len(live))
        freed = False
        for s in live:
            req = self._slot_req[s]
            d = drafts.get(s, [])
            m, commit = accept_window(d, host_nxt[s])
            n_before = len(req.out_tokens)
            req.out_tokens.extend(commit)
            self._slot_pos[s] += len(commit)
            req.spec_drafted += len(d)
            req.spec_accepted += m
            self.stats_spec_drafted += len(d)
            self.stats_spec_accepted += m
            if m < len(d):
                # rejected lanes wrote past the committed extent: masked
                # out of every later read, overwritten by the next window
                self.stats_spec_rollbacks += 1
            stopped = (req.needs_host_tokens
                       and self._hit_stop(req, n_new=len(commit)))
            # tokens the stream keeps (a stop inside the window truncates)
            self.stats_decode_tokens += len(req.out_tokens) - n_before
            freed |= self._end_if_done(s, stopped)
        if freed:
            self._after_frees()

    def _fail_live(self, exc: BaseException):
        """A tick that raised fails every live request with its error: no
        other tick or device takes over."""
        for s in np.flatnonzero(self._active):
            req = self._slot_req[int(s)]
            if not req.done.is_set():
                req.error = exc
                req.t_done = time.monotonic()
                req.done.set()

    def _drained(self) -> bool:
        with self._lock:
            return (self._intake_done and not self._inserts
                    and self._pending_prefills == 0)

    def _decode_loop(self):
        """Deviation from the reference's loop (ref engine.py:1791-1809),
        which clears the doorbell after the insert pass and, with rows
        queued, goes straight round again: with nothing live and the head
        blocked on pages, that spins (holding the GIL) until whatever
        holds the pages lets go.  Here the doorbell is cleared *before*
        the insert pass, and a pass that admits nothing with nothing live
        waits on it: every event that can unblock the head (a prefill or
        restore round queued, a prefix hold dropped, the weights loaded)
        rings it.  A drafter set picks the speculative tick."""
        tick = self._tick if self.drafter is None else self._tick_spec
        while True:
            self._work.clear()
            self._do_inserts()
            if self._active.any():
                try:
                    tick()
                except BaseException as e:      # noqa: BLE001 — re-raised
                    self._fail_live(e)
                    raise
                continue
            self._last_tick_t = None     # idle gap: not tick jitter
            if self._drained():
                break
            # nothing live: a monitored wait frees this core for prefill /
            # weights / intake work
            io.wait(self._work, self.idle_wait)

    # ------------------------------------------------------------ reporting
    def stats(self) -> dict:
        """The reference's key set."""
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
            "evictions": self.stats_evictions,
            "restores": self.stats_restores,
            "pages_grown": self.stats_pages_grown,
            "pages_grown_multi": self.stats_pages_grown_multi,
            "restore_divergences": len(self.restore_divergences),
            "decode_dispatches": self.stats_decode_dispatches,
            "dispatches_per_token": (
                self.stats_decode_dispatches
                / max(self.stats_decode_tokens, 1)),
            "spec": self.spec_mode or "off",
            "spec_k": self.spec_k if self.spec_mode else 0,
            "spec_drafted": self.stats_spec_drafted,
            "spec_accepted": self.stats_spec_accepted,
            "spec_rollbacks": self.stats_spec_rollbacks,
            "spec_accept_rate": (self.stats_spec_accepted
                                 / max(self.stats_spec_drafted, 1)),
            "prefix_cache": self.prefix is not None,
            "prefix_hits": self.stats_prefix_hits,
            "prefix_tokens_saved": self.stats_prefix_tokens_saved,
            "cow_forks": self.stats_cow_forks,
            "policy": self.policy.name,
            "donate": self.donate,
            "paged_kernel": self.paged_kernel,
            "tp": self.tp,
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


__all__ = ["ServeEngine", "PORT_ONLY_STATS", "accept_window",
           "auto_page_size", "percentile"]
