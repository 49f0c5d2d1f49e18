"""Meshes over ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

The reference's mesh is one process holding every device, and GSPMD
inserts the collectives.  Here a mesh is one process per rank: rank 0 is
the caller's process, ranks 1..n-1 are followers started by
:func:`spawn_followers` (the ``spawn`` start method), which loop in
``repro_torch.serve.tp`` running what rank 0 dispatches.  The ranks meet
through a ``FileStore`` in a temporary directory (no fixed TCP port) and
talk on two planes:

  * the data plane: a process group over all of the mesh's ranks
    (``nccl`` when each rank has a card of its own, ``gloo`` otherwise),
    and one group per axis: for each data coordinate a ``model`` group of
    the ranks that share it, for each model coordinate a ``data`` group.
    The model's tensor-parallel collectives (``models.layers``) run over
    ``model``, FSDP's gathers and gradient sums (``sharding.fsdp``) over
    ``data``;
  * the control plane, a pipe from rank 0 to each follower, carrying the
    step dispatches in one total order (``serve.tp``).

Ranks are pod-major, then data-major: rank ``(p * D + d) * M + m`` sits
at pod coordinate ``p``, data coordinate ``d`` and model coordinate
``m`` (``D``, ``M`` the data and model axes).  The axis groups are built
directly on the rendezvous ``FileStore``, each under a prefix of its own
and with its members' coordinates as ranks, the same as
``torch.distributed.new_group`` would make them but without a default
group, so that one process can hold meshes one after another.  Every rank
builds the model group of its (pod, data) coordinates first, then the
data group of its (pod, model), then the pod group of its (data, model),
so no rank waits on a peer that is still joining another group.  An axis
of size 1 has no group: a collective over it is the identity.

The backend and each rank's device are chosen explicitly and printed;
no backend gives way to another.  On ``gloo`` only ``all_reduce``,
``broadcast`` and ``all_gather`` are used (gloo has no CUDA
``reduce_scatter``, ``all_to_all`` or ``send``/``recv``).  Every collective
times out (``TIMEOUT_S``) rather than hangs, and a follower that dies
makes rank 0's next collective raise at once.

The axes are the reference's ``("pod", "data", "model")``; ``pod`` is 1
unless a spec names it (``"POD,DATA,MODEL"``), and a mesh whose pod axis
is 1 has no ``pod`` entry in its shape, so every two-axis mesh is as it
was.  Serving splits only ``model`` (``TP_SERVE_RULES`` maps ``batch``
to nothing, and ``steps.check_tp`` refuses a data or pod axis above 1);
training splits all three (``LOGICAL_RULES``: the batch over pod x data,
FSDP over ``data`` alone, so parameters and moments are whole across
pods, tensor parallelism over ``model``: ``steps.make_train_step``).  A
collective names its axis; one without an axis runs over all ranks only
while at most one axis is above 1, and raises otherwise.

The production meshes of the reference's dry run, 16x16 ``("data",
"model")`` and 2x16x16 ``("pod", "data", "model")``, are layouts, not 256
or 512 ranks: :func:`make_production_mesh` returns a :class:`LayoutMesh`
at rank 0's coordinates with no processes, whose collectives take meta
tensors only, return the shapes a real collective would and record each
call (kind, axis, group size, result bytes; ``launch.analysis.
CollectiveStats`` counts them).
"""
from __future__ import annotations

import datetime
import math
import os
import shutil
import tempfile

import torch

from ..device import rank_device

# the data plane's collective timeout: a rank that stops answering fails
# its peers' collectives after this long, never hangs them
TIMEOUT_S = 120.0


AXES = ("pod", "data", "model")


def _full_shape(shape) -> dict:
    """``shape`` (a mapping axis -> size, or a (data, model) or (pod,
    data, model) tuple) as the mesh keeps it: data and model always, pod
    only where it is above 1, in ``AXES`` order."""
    if not isinstance(shape, dict):
        shape = dict(zip(AXES[-len(shape):], shape))
    out = {a: int(shape.get(a, 1)) for a in AXES}
    if out["pod"] == 1:
        del out["pod"]
    return out


class Mesh:
    """Axis sizes (``{"data": d, "model": m}``, with ``"pod"`` first where
    it is above 1), this process's rank and its coordinates on each axis
    (``pod`` among them, 0 without one), the data plane's process groups
    (the whole mesh's, ``group``, and this rank's group on each axis,
    ``groups``), the backend and this rank's device.  Rank 0's mesh also
    owns the follower processes and their pipes (``conns``); :meth:`close`
    stops and joins them."""

    def __init__(self, shape, rank=0, *, backend=None, group=None,
                 groups=None, device_type="cuda", procs=(), conns=(),
                 tmpdir=None):
        self.shape = _full_shape(shape)
        d, m = self.shape["data"], self.shape["model"]
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self.coords = {"pod": rank // (d * m), "data": rank // m % d,
                       "model": rank % m}
        self.backend = backend
        self.group = group
        self.groups = dict(groups or {})
        self.device_type = device_type
        self.procs = list(procs)
        self.conns = list(conns)
        self._tmpdir = tmpdir
        self.closed = False

    def device(self, device_type=None) -> torch.device:
        """This rank's device for ``device_type`` (default the mesh's):
        the CPU, ``cuda:rank`` under nccl, one shared card under gloo."""
        return rank_device(device_type or self.device_type, self.rank,
                           self.backend)

    def for_rank(self, rank: int) -> "Mesh":
        """A view of the mesh at another rank (its shape and coordinates
        only): what ``sharding.local_shard`` needs to cut that rank's
        shard."""
        return Mesh(self.shape, rank, backend=self.backend,
                    device_type=self.device_type)

    def describe(self) -> str:
        return ("mesh " + " ".join(f"{a}={n}" for a, n in self.shape.items())
                + f" backend={self.backend} ranks on "
                + ", ".join(str(self.for_rank(r).device())
                            for r in range(self.size)))

    # ------------------------------------------------------------ data plane
    def _axis(self, axis):
        """(axis, its size): ``axis`` is "pod", "data", "model" or "all";
        no axis is the whole mesh, while at most one axis is above 1."""
        if axis is None:
            if sum(n > 1 for n in self.shape.values()) > 1:
                raise ValueError(
                    f"mesh {self.shape}: a collective on a mesh with two "
                    "axes above 1 names its axis ('pod', 'data', 'model' "
                    "or 'all')")
            axis = "all"
        if axis == "all":
            return axis, self.size
        if axis not in AXES:
            raise ValueError(f"axis {axis!r}: pick 'pod', 'data', 'model' "
                             "or 'all'")
        return axis, self.shape.get(axis, 1)

    def _group_of(self, axis):
        """(process group, size) of ``axis`` (:meth:`_axis`) for this
        rank; an axis of size 1 has no group."""
        axis, n = self._axis(axis)
        if n == 1:
            return None, 1
        return (self.group if n == self.size else self.groups[axis]), n

    def all_reduce(self, t: torch.Tensor, axis=None) -> torch.Tensor:
        """Sum ``t`` over the ranks of ``axis`` (see :meth:`_group_of`),
        in place; returns it."""
        group, _ = self._group_of(axis)
        if group is not None:
            group.allreduce([t]).wait()
        return t

    def all_gather(self, t: torch.Tensor, axis=None) -> list[torch.Tensor]:
        """Every rank's ``t`` on ``axis``, in the order of its
        coordinate."""
        group, n = self._group_of(axis)
        if group is None:
            return [t]
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(n)]
        group.allgather([outs], [t]).wait()
        return outs

    # ------------------------------------------------------------- lifetime
    def close(self, timeout_s: float = 30.0) -> None:
        """Rank 0: tell every follower to exit, join it (terminating one
        that does not leave within ``timeout_s``), remove the rendezvous
        directory.  Idempotent."""
        if self.closed:
            return
        self.closed = True
        for c in self.conns:
            try:
                c.send(("exit",))
            except (BrokenPipeError, OSError):
                pass                    # already gone
        for p in self.procs:
            p.join(timeout_s)
            if p.is_alive():
                p.terminate()
                p.join(timeout_s)
        for c in self.conns:
            c.close()
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)

    def abort(self) -> None:
        """Rank 0, after a failure: terminate the followers now (a
        follower may sit in a collective that will never complete)."""
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        self.close(timeout_s=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        return f"<Mesh rank {self.rank} of {self.shape} {self.backend}>"


class LayoutMesh(Mesh):
    """A mesh as a layout: its axis sizes and one rank's coordinates (rank
    0's by default), no processes and no process groups.  A step run
    under it on meta tensors (``launch.dryrun``) takes the rank's local
    shapes and meets every collective it would run on a real mesh of this
    shape: :meth:`all_reduce` and :meth:`all_gather` accept meta tensors
    only, return what the collective would (the tensor, or ``n`` of its
    shape), and append ``(kind, axis, group size, result bytes)`` to
    :attr:`records` (an axis of size 1 runs no collective and records
    nothing).  On a tensor with data they raise: a layout is not
    ``size`` ranks."""

    def __init__(self, shape, rank=0):
        super().__init__(shape, rank, device_type="meta")
        self.records: list[tuple[str, str, int, int]] = []

    def device(self, device_type=None) -> torch.device:
        return torch.device("meta")

    def _size_of(self, axis, t, kind):
        if t.device.type != "meta":
            raise RuntimeError(
                f"{kind} on a {t.device.type} tensor: a layout mesh "
                f"{self.shape} takes meta tensors only (it is not "
                f"{self.size} ranks)")
        return self._axis(axis)

    def all_reduce(self, t, axis=None):
        axis, n = self._size_of(axis, t, "all_reduce")
        if n > 1:
            self.records.append(("all-reduce", axis, n,
                                 t.numel() * t.element_size()))
        return t

    def all_gather(self, t, axis=None):
        axis, n = self._size_of(axis, t, "all_gather")
        if n == 1:
            return [t]
        self.records.append(("all-gather", axis, n,
                             n * t.numel() * t.element_size()))
        return [torch.empty_like(t, memory_format=torch.contiguous_format)
                for _ in range(n)]

    def close(self, timeout_s: float = 30.0) -> None:
        self.closed = True

    def __repr__(self):
        return f"<LayoutMesh rank {self.rank} of {self.shape}>"


def make_production_mesh(multi_pod: bool = False) -> LayoutMesh:
    """The reference's production mesh as a layout (:class:`LayoutMesh`,
    rank 0's coordinates): 16x16 ``("data", "model")``, or with
    ``multi_pod`` 2x16x16 ``("pod", "data", "model")``."""
    return LayoutMesh((2, 16, 16) if multi_pod else (16, 16))


def make_host_mesh(device_type="cuda") -> Mesh:
    """The (1, 1) mesh: one rank, no process group (the axes are present,
    so sharding annotations need no no-mesh special case)."""
    return Mesh({"data": 1, "model": 1}, 0, device_type=device_type)


def _visible_devices() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _parse(spec: str):
    try:
        shape = tuple(int(p) for p in spec.split(","))
    except ValueError:
        shape = ()
    if len(shape) not in (2, 3) or any(p < 1 for p in shape):
        raise ValueError(f"mesh spec {spec!r}: want 'DATA,MODEL' or "
                         "'POD,DATA,MODEL' positive sizes")
    return shape


def make_mesh_from_devices(spec: str | None = None, backend: str | None = None,
                           device_type: str | None = None) -> Mesh:
    """The (data, model) mesh over the visible devices, by the reference's
    rules: by default every device on the model axis (``(1, n)``); a single
    visible device is the (1, 1) host mesh; ``spec`` ("DATA,MODEL", or
    "POD,DATA,MODEL" for the reference's third axis) overrides the shape,
    and its sizes must multiply to the visible device count.  Its ranks
    then run one per card on ``nccl``.

    ``backend="gloo"`` is the explicit opt-in to ranks that share a
    card: any mesh size, every rank on the one card there is
    (``cuda:0``), or rank r on card r mod count.  ``backend="nccl"`` asks
    for one card per rank and raises without them.  On the CPU
    (``device_type="cpu"``, the tests) every rank computes on the host,
    no card is counted, and the backend is gloo.  A ``data`` or ``pod``
    axis above 1 is a training mesh (FSDP, the batch over pod x data);
    serving refuses it (``steps.check_tp``).

    ``device_type`` (default: ``cuda`` when a card is visible, else
    ``cpu``) is where the followers compute; the engine on rank 0 is
    given its own ``device``."""
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: pick 'gloo' or 'nccl'")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    n = _visible_devices()
    shape = (1, n) if spec is None else _parse(spec)
    size = math.prod(shape)
    if device_type == "cpu":
        if backend == "nccl":
            raise ValueError("backend nccl needs cards; the CPU ranks use "
                             "gloo")
        backend = "gloo"
    elif backend != "gloo" and size != n:
        raise ValueError(f"mesh spec {spec!r}: "
                         f"{'x'.join(map(str, shape))} != {n} visible "
                         "devices")
    if size == 1:
        return make_host_mesh(device_type)
    if backend is None:
        backend = "nccl"
    if backend == "nccl" and torch.cuda.device_count() < size:
        raise RuntimeError(
            f"backend nccl needs {size} cards, "
            f"{torch.cuda.device_count()} visible (backend='gloo' shares "
            "one)")
    return spawn_followers(shape, backend, device_type)


def _group(store, rank, size, backend, device, prefix="data"):
    """A process group of the data plane, built directly (no global
    default group, so one process can hold meshes one after another) on
    the store under ``prefix``, this process as ``rank`` of ``size``."""
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store = dist.PrefixStore(prefix, store)
    if backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
        opts._timeout = timeout
        # loopback: every rank is on this host
        opts._devices = [dist.ProcessGroupGloo.create_device(
            hostname="127.0.0.1")]
        return dist.ProcessGroupGloo(store, rank, size, opts)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        torch.cuda.set_device(device)
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    raise ValueError(f"backend {backend!r}")


def _join(mesh, store):
    """This rank's groups: the whole mesh's, then the group of each axis
    above 1 that is not the whole mesh, in ``AXES``' reverse order (model,
    data, pod) on every rank, each keyed by the rank's coordinates on the
    other axes."""
    dev = mesh.device()
    mesh.group = _group(store, mesh.rank, mesh.size, mesh.backend, dev)
    for axis in reversed(AXES):
        n = mesh.shape.get(axis, 1)
        if 1 < n < mesh.size:
            key = ".".join(str(mesh.coords[a]) for a in AXES if a != axis)
            mesh.groups[axis] = _group(store, mesh.coords[axis], n,
                                       mesh.backend, dev,
                                       prefix=f"{axis}{key}")


def _store(path, size):
    import torch.distributed as dist

    store = dist.FileStore(path, size)
    store.set_timeout(datetime.timedelta(seconds=TIMEOUT_S))
    return store


def _follower_main(rank, shape, backend, device_type, path, conn):
    """A follower's process: join the data plane, then serve dispatches
    until rank 0 says exit (or its pipe closes)."""
    from ..serve import tp

    if device_type == "cpu":
        torch.set_num_threads(1)        # ranks share the host's cores
    conn.send(("up", rank))             # imported: rank 0 may rendezvous
    mesh = Mesh(shape, rank, backend=backend, device_type=device_type)
    _join(mesh, _store(path, mesh.size))
    tp.follower_loop(mesh, conn)


def _await_up(rank, proc, conn):
    """Wait for follower ``rank`` to report that it started; raise at
    once if its process died first, or after ``TIMEOUT_S``."""
    import time

    deadline = time.monotonic() + TIMEOUT_S
    while not conn.poll(0.1):
        if not proc.is_alive():
            raise RuntimeError(f"mesh rank {rank} exited with code "
                               f"{proc.exitcode} while starting")
        if time.monotonic() > deadline:
            raise TimeoutError(f"mesh rank {rank} did not start within "
                               f"{TIMEOUT_S} s")
    msg = conn.recv()
    if msg != ("up", rank):
        raise RuntimeError(f"mesh rank {rank}: unexpected {msg!r}")


def spawn_followers(shape, backend: str, device_type: str) -> Mesh:
    """Start ranks 1..n-1 of a ``shape`` mesh (``spawn``), join rank 0 to
    the data plane, and return rank 0's mesh, which owns the followers."""
    import multiprocessing as mp

    shape = _full_shape(shape)
    size = math.prod(shape.values())
    tmpdir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    path = os.path.join(tmpdir, "store")
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    try:
        for r in range(1, size):
            here, there = ctx.Pipe()
            p = ctx.Process(target=_follower_main, daemon=True,
                            args=(r, shape, backend, device_type, path,
                                  there),
                            name=f"repro_torch-rank{r}")
            p.start()
            there.close()
            procs.append(p)
            conns.append(here)
        for r, (p, c) in enumerate(zip(procs, conns), start=1):
            _await_up(r, p, c)
        mesh = Mesh(shape, 0, backend=backend, device_type=device_type,
                    procs=procs, conns=conns, tmpdir=tmpdir)
        _join(mesh, _store(path, size))
    except BaseException:
        for p in procs:
            p.terminate()
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise
    return mesh


__all__ = ["AXES", "LayoutMesh", "Mesh", "TIMEOUT_S", "make_host_mesh",
           "make_mesh_from_devices", "make_production_mesh",
           "spawn_followers"]
