"""Fault-tolerant checkpointing with UMT-overlapped writes (PyTorch port
of ``repro/checkpoint/manager.py``, same on-disk format).

Layout per step::

    <dir>/step_000123.tmp/           (written, fsync'd)
        manifest.json                (leaf shapes, dtypes, crc32s)
        leaf_00000.npy ...           (one file per tree leaf, raw bytes)
    <dir>/step_000123/               (atomic rename = commit)

Leaves are numbered in the reference's order (``jax.tree_util``: dict
keys sorted, tuples in order; ``models.layers.tree_leaves``), each file
holds the leaf's raw bytes and the manifest names its dtype as numpy
does (``"float32"``, ``"bfloat16"``, ``"int32"``), so a checkpoint that
either package writes loads in the other.

Guarantees:
  * atomic commit — a crash mid-save never corrupts the latest checkpoint
    (uncommitted ``.tmp`` dirs are ignored and garbage-collected);
  * integrity — crc32 per leaf, verified on load;
  * async — each leaf write is a UMT task (monitored write and fsync),
    so training compute overlaps checkpoint I/O; ``wait()`` fences
    durability;
  * keep-N retention;
  * snapshot at save — every leaf is copied to the host before ``save``
    returns, because the port's train step updates the state in place;
  * bf16 leaves go over by their bits (no ``ml_dtypes`` needed).

On load, leaves are placed on ``device`` (default: each template leaf's
own device).

Mesh-portable, as the reference's checkpoints are: leaves are stored
whole whatever the mesh.  On a mesh (``sharding.fsdp``) the save's
snapshot (:func:`snapshot`) assembles each split leaf on rank 0's host
from every rank's block, gathered over ``data`` and then over ``model``,
the other ranks taking part only in the gathers, and rank 0 writes the
files; a restore onto a mesh (``load_checkpoint(..., mesh=)``, the
counterpart of the reference's ``shardings=``) has every rank read the
files itself and keep its block of each leaf by the layout it is given
(``dims`` and ``tp``, the train step's ``Plan``).  So a checkpoint saved
on one mesh loads on another, on one device and in the reference.
"""
from __future__ import annotations

import collections
import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core import UMTRuntime, io
from ..models.layers import tree_leaves
from ..sharding.fsdp import shard_leaf, whole_on_host

# a restore reads and checks leaves on this many threads (``readinto`` and
# ``zlib.crc32`` release the GIL), holding at most READ_BYTES of leaves
# read but not yet placed, or one leaf where a leaf is larger: one leaf at
# a time, a 31.9 GB train state took 41.00 s on an H100 machine's host,
# most of it the checksums
READ_THREADS = 8
READ_BYTES = 8 << 30


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return [_structure(t) for t in tree]
    return "*"


def _unflatten(template, leaves):
    """``leaves`` (in ``tree_leaves`` order) in ``template``'s structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


def _host_bytes(leaf, copy=True):
    """A host snapshot of ``leaf``: (raw bytes as a uint8 numpy array,
    shape, dtype name).  A copy, taken now, unless ``copy`` is False (a
    host tensor nothing else holds)."""
    host = torch.as_tensor(leaf).detach().to("cpu", copy=copy)
    raw = host.contiguous().reshape(-1).view(torch.uint8).numpy()
    return raw, list(host.shape), str(host.dtype).replace("torch.", "")


def snapshot(state, mesh=None, dims=None, tp=None):
    """Every leaf of ``state`` copied to the host now, in ``tree_leaves``
    order, as ``save_checkpoint`` writes it.  On a mesh, ``dims`` and
    ``tp`` (trees like ``state``: the dim each leaf is split along over
    ``data``, its ``sharding.fsdp.TPSplit`` over ``model``; None where
    whole) say which leaves are blocks: each is assembled whole on rank 0
    (``sharding.fsdp.whole_on_host``).  Every rank of the mesh calls it,
    in the same order; rank 0 gets the snapshot, the others None."""
    if mesh is None:
        return [_host_bytes(leaf) for leaf in tree_leaves(state)]
    leaves = tree_leaves(state)
    tps = [None] * len(leaves) if tp is None else tree_leaves(tp)
    hosts = [whole_on_host(leaf, d, mesh, sp) for leaf, d, sp in
             zip(leaves, tree_leaves(dims), tps)]
    return None if mesh.rank else [_host_bytes(h, copy=False)
                                   for h in hosts]


def _fsync_write(path: str, data):
    """Write and fsync, both monitored: a leaf of gigabytes blocks in
    ``write`` for seconds (the kernel throttles dirty pages), and the UMT
    runtime gives the core to other tasks (the next batch's prefetch)
    only for a block it is told of.  The reference monitors the fsync
    alone."""
    with open(path, "wb") as f:
        io.write(f, data)
        io.fsync(f)


def save_checkpoint(state, step: int, dirpath: str,
                    rt: UMTRuntime | None = None, wait: bool = True,
                    hosts=None):
    """Write checkpoint for `step`; returns a `wait()` callable.
    ``hosts``: the leaves' :func:`snapshot`, taken already (on a mesh,
    rank 0's); by default it is taken here."""
    os.makedirs(dirpath, exist_ok=True)
    tmp = os.path.join(dirpath, f"step_{step:06d}.tmp")
    final = os.path.join(dirpath, f"step_{step:06d}")
    os.makedirs(tmp, exist_ok=True)
    # host snapshot NOW: the caller's next train step updates these
    # tensors in place while the file writes proceed asynchronously
    if hosts is None:
        hosts = snapshot(state)
    if len(hosts) != len(tree_leaves(state)):
        raise ValueError(f"{len(hosts)} host leaves for a tree of "
                         f"{len(tree_leaves(state))}")
    manifest = {"step": step, "treedef": json.dumps(_structure(state)),
                "leaves": []}

    def write_leaf(i, host):
        raw, shape, dtype = host
        name = f"leaf_{i:05d}.npy"
        _fsync_write(os.path.join(tmp, name), raw.data)
        return {"name": name, "shape": shape, "dtype": dtype,
                "crc": zlib.crc32(raw.data)}

    results: list = [None] * len(hosts)
    if rt is None:
        for i, host in enumerate(hosts):
            results[i] = write_leaf(i, host)
        _commit(tmp, final, manifest, results)
        return lambda: None

    done = threading.Event()
    remaining = [len(hosts)]
    errors: list = []
    lock = threading.Lock()

    def task(i, host):
        try:
            results[i] = write_leaf(i, host)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
        finally:
            with lock:
                remaining[0] -= 1
                if remaining[0] == 0:
                    if not errors:
                        _commit(tmp, final, manifest, results)
                    done.set()

    for i, host in enumerate(hosts):
        rt.submit(task, i, host, name=f"ckpt{step}.{i}")

    def waiter():
        io.wait(done)
        if errors:
            raise errors[0]

    if wait:
        waiter()
    return waiter


def _commit(tmp, final, manifest, leaf_entries):
    manifest["leaves"] = leaf_entries
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        io.fsync(f)
    os.rename(tmp, final)           # atomic commit


def _committed_steps(dirpath: str) -> list[int]:
    steps = []
    if not os.path.isdir(dirpath):
        return steps
    for name in os.listdir(dirpath):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(dirpath, name,
                                            "manifest.json")):
            steps.append(int(name[5:]))
    return sorted(steps)


def _read_leaf(path, entry):
    payload = bytearray(os.path.getsize(path))   # read once, in place
    with open(path, "rb") as f:
        f.readinto(payload)
    if zlib.crc32(payload) != entry["crc"]:
        raise IOError(f"checksum mismatch in {entry['name']}")
    dtype = getattr(torch, entry["dtype"])
    if not payload:
        return torch.empty(entry["shape"], dtype=dtype)
    return torch.frombuffer(payload, dtype=dtype).reshape(entry["shape"])


def _fit(t, shape, mesh, name, cut=None):
    """The stored leaf ``t`` cut to its template's ``shape``: this rank's
    block by ``cut`` (its data dim and model split on ``mesh``) where
    given, else itself."""
    if cut is not None:
        t = shard_leaf(t, *cut, mesh)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != the "
                         f"template's {shape}")
    return t


def load_checkpoint(dirpath: str, template, step: int | None = None,
                    device=None, mesh=None, in_place=False, dims=None,
                    tp=None):
    """Load latest (or given) committed step into `template`'s structure.

    Each leaf must match its template leaf's shape; it is placed on
    ``device``, or on the template leaf's own device when None (a
    template on the ``meta`` device costs no memory).  ``mesh`` (this
    rank reads the files itself) with ``dims`` and ``tp`` (trees like the
    template, as :func:`snapshot` takes them): each leaf is cut to this
    rank's block by them.
    ``in_place``: each leaf is copied into its template leaf, which is
    returned.  Leaves are read and checked ahead on ``READ_THREADS``
    threads, at most ``READ_BYTES`` of them (or one larger leaf) held on
    the host at once."""
    steps = _committed_steps(dirpath)
    if not steps:
        return None, None
    step = steps[-1] if step is None else step
    path = os.path.join(dirpath, f"step_{step:06d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_t = tree_leaves(template)
    assert len(leaves_t) == len(manifest["leaves"]), "tree mismatch"
    cuts = ([None] * len(leaves_t) if mesh is None
            else list(zip(tree_leaves(dims), tree_leaves(tp))))
    files = [os.path.join(path, e["name"]) for e in manifest["leaves"]]
    sizes = [os.path.getsize(f) for f in files]
    out, pending, held, nxt = [], collections.deque(), 0, 0
    with ThreadPoolExecutor(READ_THREADS) as pool:
        for i, (entry, tleaf) in enumerate(zip(manifest["leaves"],
                                               leaves_t)):
            while nxt < len(files) and (
                    not pending or held + sizes[nxt] <= READ_BYTES):
                pending.append(pool.submit(_read_leaf, files[nxt],
                                           manifest["leaves"][nxt]))
                held += sizes[nxt]
                nxt += 1
            t = _fit(pending.popleft().result(), tuple(np.shape(tleaf)),
                     mesh, entry["name"], cuts[i])
            if in_place:
                out.append(tleaf.copy_(t))
            else:
                dev = device if device is not None else getattr(
                    tleaf, "device", "cpu")
                out.append(t.to(dev))
            del t
            held -= sizes[i]
    return _unflatten(template, out), step


class CheckpointManager:
    """keep-N retention + preemption-aware autosave + auto-resume."""

    def __init__(self, dirpath: str, rt: UMTRuntime | None = None,
                 keep: int = 3):
        self.dir = dirpath
        self.rt = rt
        self.keep = keep
        self.preempted = threading.Event()
        self._pending = []

    def request_preemption(self, *_args):
        """Hook for SIGTERM: checkpoint at the next step boundary."""
        self.preempted.set()

    def save(self, state, step: int, wait: bool = False, hosts=None):
        """``hosts``: the leaves' snapshot, taken already (on a mesh,
        rank 0's from :func:`snapshot`)."""
        w = save_checkpoint(state, step, self.dir, rt=self.rt, wait=wait,
                            hosts=hosts)
        self._pending.append(w)
        self._gc()
        return w

    def wait(self):
        for w in self._pending:
            w()
        self._pending.clear()

    def restore(self, template, device=None):
        """The latest checkpoint in ``template``'s structure
        (:func:`load_checkpoint`; a mesh's ranks restore through
        ``launch.train.MeshTrain.restore``)."""
        return load_checkpoint(self.dir, template, device=device)

    def latest_step(self):
        steps = _committed_steps(self.dir)
        return steps[-1] if steps else None

    def _gc(self):
        steps = _committed_steps(self.dir)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:06d}"),
                          ignore_errors=True)
        # drop stale uncommitted dirs
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                full = os.path.join(self.dir, name)
                try:
                    s = int(name[5:-4])
                except ValueError:
                    continue
                if steps and s < steps[-1]:
                    shutil.rmtree(full, ignore_errors=True)
