"""Tensor-parallel dispatch: one driver rank and follower ranks.

The reference serves tensor-parallel from one process that holds every
device; GSPMD partitions each jitted step and inserts the collectives.
The port runs one process per rank (``launch.mesh``), so a step is one
program per rank, its collectives written out in ``models.layers``.
That needs what this module provides, and the reference needs none of:

* **Rank 0 drives.**  The caller's process runs the ``ServeEngine``, its
  UMT runtime and all host-side state (queue, pager, prefix trie, policy,
  block tables).  Identical engines on every rank could not run as SPMD:
  admission is timing-dependent (prefill, decode, intake and restore are
  UMT tasks on worker threads), so their step orders would diverge and
  deadlock in a collective.
* **Followers replay.**  Every step rank 0 issues through a
  :class:`Session` goes to each follower as a small message over its pipe
  — the step's name and its host arguments (tokens, ``pos``, block
  tables, masks, chunk offsets; a tensor moves as a CPU copy) — and the
  follower runs the same step on its own shard (:func:`follower_loop`).
  Trees that live on every rank (the weights, the pool, row caches) never
  move: rank 0 holds its own as a :class:`Shard`, which travels as a key
  that each follower resolves to its own tree.  A key is assigned, on
  every rank alike, to each new tree a step returns; when rank 0 drops
  its ``Shard``, the next message tells the followers to drop theirs.
* **One order.**  Every dispatch goes out under one lock and runs to
  completion on rank 0 before the next goes out: the followers replay in
  send order, so rank 0 must issue in one total order.  Deviation: the
  reference serialises its dispatches only on its CPU substrate
  (``_tp_serial``, ``repro/serve/engine.py:422-433``, ``:714-720``); the
  port serialises on every backend.
* **Fail, never hang.**  A follower that raises sends its traceback to
  rank 0 and exits; the data plane's next collective on rank 0 then
  raises at once (gloo) or at the mesh's ``TIMEOUT_S``, and the session
  raises :class:`TPError` with the follower's traceback, tears the other
  followers down (``mesh.abort``: one may sit in a collective that will
  never complete) and refuses every later call.  The engine fails its
  live requests, as its ``_fail_live`` does.

The same dispatch drives training on a mesh (FSDP, tensor parallelism):
``launch.train.MeshTrain`` loads a train state's shards on every rank
and sends each train step, checkpoint snapshot and restore through a
:class:`Session`.
"""
from __future__ import annotations

import functools
import gc
import threading
import traceback
import weakref
import zlib
from typing import NamedTuple

import torch

from ..params import shard_params

# seconds rank 0 waits for a follower's answer to a message that asks
# for one (``run``, ``close``)
REPLY_S = 120.0


class TPError(RuntimeError):
    """A tensor-parallel step failed on some rank."""


class Ref(NamedTuple):
    """A tree that lives on every rank, by key."""
    key: object


class Shard(dict):
    """Rank 0's copy of a tree that every rank holds its own of (the
    weights, the pool, a row cache): a dict, plus the key the followers
    know their copy by."""
    __slots__ = ("tp_key", "__weakref__")


class SeededParams:
    """A per-rank weights factory: every rank draws the full seeded init
    on its own device (``models.lm.init_params``, a ``torch.Generator``
    seeded with ``seed``) and keeps its shard; so no weight crosses a
    pipe.  Picklable, so a follower can run it."""
    per_rank = True

    def __init__(self, seed: int = 0, dtype=None):
        self.seed, self.dtype = seed, dtype

    def __call__(self, cfg, mesh, device):
        from ..models.lm import init_params

        full = init_params(cfg, torch.Generator(device).manual_seed(
            self.seed), device, self.dtype)
        return shard_params(full, cfg, mesh)


def digest(t) -> tuple:
    """(shape, dtype, crc32 of the bytes) of a host tensor: what the
    :func:`seen` probe reports of each tensor argument a rank was
    handed."""
    raw = t.detach().reshape(-1).contiguous().view(torch.uint8).numpy()
    return tuple(t.shape), str(t.dtype), zlib.crc32(raw.tobytes())


class RankState:
    """What one rank holds for a session: the config, its mesh and device,
    its weights, its steps, the trees it knows by key, ``handed`` (per
    step, the host tensor arguments of its last call as the rank received
    them: kept by reference, read only by the :func:`seen` probe), and
    ``extra`` for what a ``run`` function leaves behind (a planted fault's
    context)."""

    def __init__(self, mesh, cfg, device):
        self.mesh, self.cfg, self.device = mesh, cfg, device
        self.params = None
        self.steps: dict = {}
        self.objs: dict = {}
        self.handed: dict = {}
        self.extra: dict = {}
        self.next_key = 0

    def build(self, key, maker, kw):
        if "device" in kw:                  # each rank's own device
            kw = dict(kw, device=self.device)
        self.steps[key] = maker(self.cfg, mesh=self.mesh, **kw)

    def new_key(self) -> int:
        self.next_key += 1
        return self.next_key


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _load(state, source):
    """This rank's weights from what rank 0 sent: a per-rank factory, or
    this rank's shard as host tensors."""
    if getattr(source, "per_rank", False):
        tree = source(state.cfg, state.mesh, state.device)
    else:
        tree = _map(source, lambda t: t.to(state.device))
    _install(state, tree)


def _install(state, tree):
    sh = Shard(tree)
    sh.tp_key = "params"
    state.params = sh
    state.objs["params"] = sh


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(v, fn) for v in tree)
    return fn(tree)


def _handle(mesh, state, msg):
    """One follower message; returns (state, reply or None)."""
    kind = msg[0]
    if kind == "open":
        _, cfg, device_type = msg
        return RankState(mesh, cfg, mesh.device(device_type)), None
    if kind == "params":
        _load(state, msg[1])
        return state, None
    if kind == "build":
        _, key, maker, kw = msg
        state.build(key, maker, kw)
        return state, None
    if kind == "call":
        _, key, args, kw, drops = msg
        for k in drops:
            state.objs.pop(k, None)

        def res(a):
            if isinstance(a, Ref):
                return state.objs[a.key]
            return a.to(state.device) if isinstance(a, torch.Tensor) else a

        state.handed[key] = [a for a in args if isinstance(a, torch.Tensor)]
        args = [res(a) for a in args]
        out = state.steps[key](*args, **{k: res(v) for k, v in kw.items()})
        for o in _outputs(out):
            if isinstance(o, dict) and not any(o is a for a in args):
                state.objs[state.new_key()] = o
        return state, None
    if kind == "run":
        _, fn, args = msg
        args = [state.objs[a.key] if isinstance(a, Ref) else a
                for a in args]
        return state, ("ok", fn(state, *args))
    if kind == "close":
        if state is not None:
            for ctx in state.extra.values():
                if hasattr(ctx, "__exit__"):
                    ctx.__exit__(None, None, None)
        return None, ("ok", None)
    raise ValueError(f"unknown message {kind!r}")


def follower_loop(mesh, conn) -> None:
    """A follower's life: handle rank 0's messages in order until
    ``exit`` (or the pipe closes: rank 0 is gone).  A message that raises
    sends ``("error", rank, traceback)`` to rank 0 and ends the process,
    so that rank 0's collectives with it fail at once."""
    state = None
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        if msg[0] == "exit":
            return
        try:
            state, reply = _handle(mesh, state, msg)
        except BaseException:               # noqa: BLE001 — reported, exits
            conn.send(("error", mesh.rank, traceback.format_exc()))
            raise SystemExit(1)
        if msg[0] == "close":               # the session's trees are gone
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        if reply is not None:
            conn.send(reply)


class Session:
    """Rank 0's side of one engine's life on a mesh: opens the followers'
    state, loads the weights on every rank, builds each step on every
    rank (:meth:`step`), dispatches each call to every rank under one
    lock (:meth:`call`), runs a function on every rank (:meth:`run`), and
    closes."""

    def __init__(self, mesh, cfg, device):
        if mesh.conns is None or len(mesh.conns) != mesh.size - 1:
            raise ValueError(f"{mesh!r}: rank 0's mesh (with its followers) "
                             "is needed to drive tensor parallelism")
        self.mesh, self.cfg = mesh, cfg
        self.local = RankState(mesh, cfg, torch.device(device))
        self._lock = threading.Lock()
        self._dropped: list = []
        self.broken: BaseException | None = None
        self.params = None
        self._send(("open", cfg, self.local.device.type))

    # ------------------------------------------------------------ plumbing
    def _send(self, msg):
        self._check()
        for r, c in enumerate(self.mesh.conns, start=1):
            try:
                c.send(msg)
            except (BrokenPipeError, OSError) as e:
                raise self._fail(e, f"rank {r}: its pipe is closed") from e

    def _check(self):
        """Raise if the session is broken or a follower has reported an
        error out of turn."""
        if self.broken is not None:
            raise TPError(f"the tensor-parallel session failed earlier: "
                          f"{self.broken}") from self.broken
        for c in self.mesh.conns:
            if c.poll():
                raise self._fail(None, "a follower spoke out of turn")

    def _follower_errors(self, wait_s: float) -> list[str]:
        """Every follower's error report that arrives within ``wait_s``
        (and the exit codes of followers that died without one)."""
        out = []
        for r, (c, p) in enumerate(zip(self.mesh.conns, self.mesh.procs),
                                   start=1):
            try:
                if c.poll(wait_s):
                    msg = c.recv()
                    if msg[0] == "error":
                        out.append(f"rank {msg[1]}:\n{msg[2]}")
                        continue
                    out.append(f"rank {r}: unexpected message {msg[0]!r}")
            except (EOFError, OSError):
                pass
            p.join(0.5)
            if p.exitcode not in (None, 0, 1):
                out.append(f"rank {r}: exited with code {p.exitcode}")
        return out

    def _fail(self, exc, what=None) -> TPError:
        """Mark the session broken; a TPError naming what rank 0 saw and
        what each follower reported."""
        errs = self._follower_errors(5.0)
        msg = "tensor-parallel step failed"
        if what:
            msg += f" ({what})"
        if exc is not None:
            msg += f" on rank 0: {exc!r}"
        if errs:
            msg += "; followers:\n" + "\n".join(errs)
        err = TPError(msg)
        self.broken = err
        self.mesh.abort()       # a follower may sit in a dead collective
        return err

    def _encode(self, a):
        if isinstance(a, Shard):
            return Ref(a.tp_key)
        if isinstance(a, dict):
            raise TypeError("a tree passed to a tensor-parallel step must "
                            "be a Shard every rank holds")
        if isinstance(a, torch.Tensor):
            return a.detach().cpu()
        return a

    def _keep(self, out, args):
        """Rank 0's new trees in a step's output, wrapped as Shards with
        the keys the followers give theirs."""
        kept = []
        for o in _outputs(out):
            if isinstance(o, dict) and not any(o is a for a in args):
                sh = Shard(o)
                sh.tp_key = self.local.new_key()
                weakref.finalize(sh, self._dropped.append, sh.tp_key)
                o = sh
            kept.append(o)
        return tuple(kept) if isinstance(out, tuple) else kept[0]

    def _replies(self):
        out = []
        for r, c in enumerate(self.mesh.conns, start=1):
            if not c.poll(REPLY_S):
                raise self._fail(None, f"rank {r} did not answer within "
                                       f"{REPLY_S} s")
            msg = c.recv()
            if msg[0] != "ok":
                self.broken = TPError(f"rank {msg[1]}:\n{msg[2]}")
                self.mesh.abort()
                raise self.broken
            out.append(msg[1])
        return out

    # ------------------------------------------------------------------ api
    def load(self, source, cut=shard_params) -> Shard:
        """The weights (or a train state) on every rank; returns rank 0's
        :class:`Shard`.  ``source``: a per-rank factory (``per_rank =
        True``, called as ``source(cfg, mesh, device)`` on each rank:
        :class:`SeededParams`), or the full tree on rank 0, which is cut
        here by ``cut(tree, cfg, mesh)`` (default ``shard_params``; a
        train state: ``params.shard_train_state``) and each follower's
        shard sent over its pipe as host tensors."""
        with self._lock:
            if getattr(source, "per_rank", False):
                self._send(("params", source))
            else:
                for r, c in enumerate(self.mesh.conns, start=1):
                    self._check()
                    part = cut(source, self.cfg, self.mesh.for_rank(r))
                    c.send(("params", _map(part, lambda t: t.cpu())))
            try:
                if getattr(source, "per_rank", False):
                    _load(self.local, source)
                else:
                    _install(self.local, _map(
                        cut(source, self.cfg, self.mesh),
                        lambda t: t.to(self.local.device)))
            except BaseException as e:          # noqa: BLE001
                raise self._fail(e) from e
            self.params = self.local.params
            return self.params

    def step(self, key, maker, **kw):
        """Build ``maker(cfg, mesh=mesh, **kw)`` on every rank (a ``device``
        keyword names each rank's own device) and return a callable that
        dispatches it: ``session.step(...)(*args, **kw)``."""
        with self._lock:
            self._send(("build", key, maker, kw))
            self.local.build(key, maker, kw)
        return functools.partial(self.call, key)

    def call(self, key, *args, **kw):
        """Run step ``key`` on every rank: the message to the followers
        first, then rank 0's own call, all under the session's lock."""
        with self._lock:
            # a finalizer may append from any thread: pop, never clear
            drops = []
            while self._dropped:
                drops.append(self._dropped.pop())
            enc = [self._encode(a) for a in args]
            self.local.handed[key] = [a for a in enc
                                      if isinstance(a, torch.Tensor)]
            self._send(("call", key, enc,
                        {k: self._encode(v) for k, v in kw.items()}, drops))
            # rank 0 runs on its device too, as each follower does
            dev = self.local.device

            def here(a):
                return a.to(dev) if isinstance(a, torch.Tensor) else a
            try:
                out = self.local.steps[key](
                    *[here(a) for a in args],
                    **{k: here(v) for k, v in kw.items()})
            except BaseException as e:          # noqa: BLE001
                raise self._fail(e) from e
            return self._keep(out, args)

    def run(self, fn, *args) -> list:
        """``fn(rank_state, *args)`` on every rank (followers first, then
        rank 0); a :class:`Shard` argument is each rank's own tree.
        Returns the results in rank order.  ``fn`` must be importable by
        name (a module-level function): the followers unpickle it."""
        with self._lock:
            self._send(("run", fn, [self._encode(a) if isinstance(a, Shard)
                                    else a for a in args]))
            try:
                mine = fn(self.local, *args)
            except BaseException as e:          # noqa: BLE001
                raise self._fail(e) from e
            return [mine] + self._replies()

    def close(self) -> None:
        """End the session on every rank: followers drop everything and
        answer.  After a failure there is nothing to end: the session tore
        the followers down when it failed (``mesh.abort``).  Idempotent."""
        with self._lock:
            if self.local is None:
                return
            for ctx in self.local.extra.values():
                if hasattr(ctx, "__exit__"):
                    ctx.__exit__(None, None, None)
            self.local = self.params = None
            if self.broken is None:
                self._send(("close",))
                self._replies()


def seen(state, key):
    """``Session.run`` probe: the :func:`digest` of each tensor argument
    of step ``key``'s last call as this rank was handed it (None before
    the first call)."""
    handed = state.handed.get(key)
    return None if handed is None else [digest(a) for a in handed]


def counters(state, reset=False):
    """``Session.run`` probe: this rank's kernel launch counts, its
    tensor-parallel collective counts (forward and backward) and its FSDP
    gathers and sums, each with its bytes (zeroed after reading when
    ``reset``)."""
    from .. import kernels
    from ..models import layers

    from ..sharding import fsdp

    out = {}
    counts = {name: getattr(kernels, name).launches for name in (
        "flash_attention", "paged_decode_attention",
        "paged_mla_decode_attention", "rms_norm", "rms_norm_bwd",
        "rms_norm_dot", "rms_norm_bwd_rstd", "ssd_scan", "ssd_scan_bwd")}
    for name in ("tp_all_reduce", "tp_all_gather", "tp_enter",
                 "tp_norm_dot"):
        op = getattr(layers, name)
        counts.update({name: op.calls, f"{name}_bytes": op.bytes})
    counts.update(fsdp_gather=fsdp.gather.calls,
                  fsdp_gather_bytes=fsdp.gather.bytes,
                  fsdp_sum=fsdp.data_sum.calls,
                  fsdp_sum_bytes=fsdp.data_sum.bytes,
                  tp_sum=fsdp.model_sum.calls,
                  tp_sum_bytes=fsdp.model_sum.bytes,
                  pod_sum=fsdp.pod_sum.calls,
                  pod_sum_bytes=fsdp.pod_sum.bytes)
    for name, c in counts.items():
        out[name] = c.value
        if reset:
            c.reset()
    return out


def tree_bytes(state, tree):
    """``Session.run`` probe: {leaf path: (bytes, data_ptr)} of this
    rank's copy of ``tree`` (a pool, a row cache, the weights)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        elif isinstance(t, (tuple, list)):
            for i, x in enumerate(t):
                walk(x, f"{path}[{i}]")
        else:
            out[path] = (t.numel() * t.element_size(), t.data_ptr())

    walk(tree, "")
    return out


__all__ = ["Session", "Shard", "Ref", "RankState", "SeededParams",
           "TPError", "follower_loop", "digest", "seen", "counters",
           "tree_bytes"]
