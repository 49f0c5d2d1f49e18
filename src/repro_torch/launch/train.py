"""Training CLI (PyTorch port of ``repro/launch/train.py``).

The host side runs ON the UMT runtime: data prefetch (``UMTPrefetcher``),
async checkpoint writes (``CheckpointManager``, one task per leaf, its
write and fsync monitored) and heartbeats are UMT tasks whose blocking
I/O releases cores to other host work, so the step never waits on a
blocked host thread.

    PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \
        --steps 50 --ckpt-dir <dir> [--resume] [--umt-off]

The reference CLI's flags and JSON lines (one per logged step, then the
closing ``wall_s`` / ``host_cpu_util`` / ``host_wakes`` line), plus
``--device {cuda,cpu}`` (default ``cuda``; ``cuda`` without a card
raises).  The CLI trains on one device, as the reference's does (its
``train`` builds no mesh but the host's, and it has no ``--mesh``); the
sharded train state (FSDP over ``data``, tensor parallelism over
``model``, the batch over pod x data, on any ``D,M`` or ``P,D,M`` mesh)
is reached through :func:`build` with
``mesh=``, the reference's ``build(cfg, mesh, hp)``, which drives the
mesh's ranks from this process (:class:`MeshTrain`).  Weights are a seeded
``torch.Generator`` init (seed 0) on the device; batches come from
``SyntheticTokenSource`` (seed 1234), as in the reference, with (…, K)
codebook ids for the audio frontend.  The vision frontend is refused
with ``ValueError``: the reference's CLI feeds it no patch embeddings,
and its forward asserts them in train mode.  Heartbeats go to a
temporary directory.
"""
from __future__ import annotations

import argparse
import json
import signal
import tempfile
import time

import torch

from ..checkpoint import CheckpointManager, load_checkpoint, snapshot
from ..configs import get
from ..core import UMTRuntime
from ..data import SyntheticTokenSource, UMTPrefetcher
from ..device import resolve_device
from ..ft import HeartbeatMonitor, StragglerDetector
from ..models.layers import tree_leaves
from ..models.lm import init_params
from ..optim import OptHParams, adamw_init
from ..params import shard_train_state, train_shard
from ..steps import (check_train_mesh, init_train_state, make_train_step,
                     train_plan)


def build(cfg, hp, device, mesh=None):
    """(step_fn, state) for ``cfg``: the seeded train state (seed 0) and
    its train step, as the reference's ``build(cfg, mesh, hp)``.  On a
    mesh of more than one rank, ``step_fn`` is a :class:`MeshTrain`'s
    ``step`` (``step_fn.__self__`` saves, restores and closes it) and
    ``state`` rank 0's shard."""
    if mesh is None or mesh.size == 1:
        state = init_train_state(cfg, torch.Generator(device).manual_seed(0),
                                 hp, device)
        return make_train_step(cfg, hp), state
    trainer = MeshTrain(cfg, hp, mesh, device, SeededTrainState(0))
    return trainer.step, trainer.state


class SeededTrainState:
    """A per-rank train state factory: every rank draws the whole seeded
    master params of ``init_train_state`` on its own device and keeps its
    blocks (``params.train_shard``), m and v zeros of their shapes, so no
    weight crosses a pipe and no rank holds whole moments.  Picklable, so
    a follower can run it."""
    per_rank = True

    def __init__(self, seed: int = 0):
        self.seed = seed

    def __call__(self, cfg, mesh, device):
        check_train_mesh(cfg, mesh)
        params = train_shard(init_params(
            cfg, torch.Generator(device).manual_seed(self.seed), device,
            dtype=cfg.param_dtype), cfg, mesh)
        return {"params": params, "opt": adamw_init(params, cfg.opt_dtype),
                "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_mesh_train_step(cfg, mesh, hp=OptHParams()):
    """A mesh rank's train step, ``(state, tokens, labels,
    patches=None) -> (state, metrics)``: the batch's leaves come apart,
    since a ``serve.tp.Session`` hands tensors to the ranks as host
    copies, not trees."""
    step = make_train_step(cfg, hp, mesh)

    def train_step(state, tokens, labels, patches=None):
        batch = {"tokens": tokens, "labels": labels}
        if patches is not None:
            batch["patches"] = patches
        return step(state, batch)

    return train_step


def make_snapshot_step(cfg, mesh):
    """``(state) -> snapshot``: a checkpoint's host snapshot of a train
    state on a mesh (``checkpoint.snapshot``): every rank gathers over
    both axes, rank 0 gets the whole leaves, the others None."""
    plan = train_plan(cfg, mesh)
    dims, tp = plan.state_dims(), plan.state_tp()
    return lambda state: snapshot(state, mesh, dims, tp)


def make_restore_step(cfg, mesh):
    """``(state, dirpath, step=None) -> (state, step)``: a mesh rank
    reads the checkpoint itself and copies its blocks, cut by the step's
    layout, into its state in place (``checkpoint.load_checkpoint(...,
    mesh=, in_place=True)``); ``step`` None when ``dirpath`` holds
    none."""
    plan = train_plan(cfg, mesh)
    dims, tp = plan.state_dims(), plan.state_tp()

    def restore_step(state, dirpath, step=None):
        _, got = load_checkpoint(dirpath, state, step, mesh=mesh,
                                 in_place=True, dims=dims, tp=tp)
        return state, got

    return restore_step


class MeshTrain:
    """Training on a ``D,M`` or ``P,D,M`` mesh (FSDP over ``data``, tensor
    parallelism over ``model``, the batch over pod x data), driven from
    rank 0, this process,
    which runs the loop, the prefetcher and the ``CheckpointManager`` on
    its UMT runtime: each train step, checkpoint snapshot and restore goes
    to every rank in one order through a ``serve.tp.Session``, the batch
    as a host copy.  A follower that raises fails the call with
    ``TPError``.  ``state``: the whole train state as torch tensors (cut
    on rank 0, each follower's shard sent as host tensors) or a per-rank
    factory (:class:`SeededTrainState`)."""

    def __init__(self, cfg, hp, mesh, device, state):
        from ..serve.tp import Session

        check_train_mesh(cfg, mesh)
        self.sess = Session(mesh, cfg, resolve_device(device))
        try:
            self.state = self.sess.load(state, cut=shard_train_state)
            self._train = self.sess.step("train", make_mesh_train_step,
                                         hp=hp)
            self._snapshot = self.sess.step("snapshot", make_snapshot_step)
            self._restore = self.sess.step("restore", make_restore_step)
        except BaseException:
            self.sess.close()
            raise

    def step(self, state, batch):
        """One train step on every rank: (state, metrics), rank 0's."""
        return self._train(state, batch["tokens"], batch["labels"],
                           batch.get("patches"))

    def save(self, mgr, state, step, wait=False):
        """Checkpoint ``state`` at ``step`` through ``mgr`` (rank 0's
        ``CheckpointManager``): the ranks' snapshot, then rank 0's UMT
        writes; returns the manager's ``wait()`` callable."""
        return mgr.save(state, step, wait=wait, hosts=self._snapshot(state))

    def restore(self, dirpath, state, step=None):
        """The latest (or ``step``'s) checkpoint under ``dirpath`` into
        ``state`` on every rank, in place; returns (state, step)."""
        return self._restore(state, dirpath, step)

    def close(self):
        self.sess.close()


def train(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config of the same family (CPU-sized)")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override tiny d_model (e.g. 512 for ~100M)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--umt-off", action="store_true",
                    help="baseline host runtime (no UMT events)")
    ap.add_argument("--cores", type=int, default=2)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if cfg.frontend == "vision_patches":
        raise ValueError(
            f"{cfg.name}: the train CLI has no patch embeddings to feed the "
            "vision frontend (the reference's CLI feeds none either, and "
            "its forward asserts them in train mode); train it through "
            "steps.make_train_step with batch['patches']")
    if args.tiny:
        over = {}
        if args.d_model:
            over.update(d_model=args.d_model,
                        head_dim=max(32, args.d_model // 8),
                        d_ff=args.d_model * 4)
        if args.n_layers:
            over["n_layers"] = args.n_layers * len(cfg.pattern)
        if args.vocab:
            over["vocab"] = args.vocab
        cfg = cfg.tiny(**over)
    device = resolve_device(args.device)

    hp = OptHParams(lr=args.lr, warmup=max(args.steps // 20, 5),
                    total_steps=args.steps)
    step_fn, state = build(cfg, hp, device)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"umt={'off' if args.umt_off else 'on'}")

    src = SyntheticTokenSource(
        seed=1234, batch=args.batch, seq=args.seq, vocab=cfg.vocab,
        accum=args.accum,
        extra_dim=cfg.n_codebooks if cfg.frontend == "audio_codebooks"
        else 0)

    t_start = time.time()
    losses = []
    old_handler = None
    # the runtime shuts down (its heartbeat tasks done) before the
    # heartbeat directory goes
    with tempfile.TemporaryDirectory(prefix="repro_torch_hb") as hb_dir, \
            UMTRuntime(n_cores=args.cores, umt=not args.umt_off) as rt:
        mgr = CheckpointManager(args.ckpt_dir, rt=rt) if args.ckpt_dir \
            else None
        hb = HeartbeatMonitor(hb_dir, n_hosts=1)
        straggle = StragglerDetector(n_hosts=1)
        start_step = 0
        if mgr and args.resume:
            restored, rstep = mgr.restore(state)
            if restored is not None:
                state = restored
                start_step = int(rstep)
                print(f"resumed from step {start_step}")
        if mgr:
            old_handler = signal.signal(signal.SIGTERM,
                                        mgr.request_preemption)
        try:
            pf = UMTPrefetcher(src, rt, depth=2, start_step=start_step)
            for step in range(start_step, args.steps):
                t0 = time.time()
                batch = pf.get(step)
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                losses.append(loss)
                dt = time.time() - t0
                straggle.record(0, dt)
                hb.beat_task(rt, 0)
                if step % args.log_every == 0 or step == args.steps - 1:
                    print(json.dumps({
                        "step": step, "loss": round(loss, 4),
                        "gnorm": round(float(metrics["grad_norm"]), 3),
                        "lr": float(metrics["lr"]),
                        "s_per_step": round(dt, 3)}))
                if mgr and ((step + 1) % args.ckpt_every == 0 or
                            mgr.preempted.is_set()):
                    mgr.save(state, step + 1, wait=False)  # async
                    if mgr.preempted.is_set():
                        print("preempted: checkpointed, exiting")
                        break
            if mgr:
                mgr.wait()
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
        host_stats = rt.stats()

    wall = time.time() - t_start
    print(json.dumps({
        "wall_s": round(wall, 2),
        "first_loss": round(losses[0], 4) if losses else None,
        "last_loss": round(losses[-1], 4) if losses else None,
        "host_cpu_util": round(host_stats["cpu_util"], 3),
        "host_oversub": round(host_stats["oversub_frac"], 4),
        "host_wakes": host_stats["wakes"],
    }))
    return losses


if __name__ == "__main__":
    train()
