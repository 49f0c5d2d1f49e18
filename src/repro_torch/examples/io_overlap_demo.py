"""The paper's claim, applied to training: checkpoint I/O overlapped with
compute via UMT vs a synchronous baseline (port of
``examples/io_overlap_demo.py``).

Trains the same small model twice with aggressive checkpointing (every
step, fsync'd):
  * baseline: synchronous saves — the step loop stalls on disk;
  * UMT: saves are UMT tasks; blocked fsyncs release the host core and the
    next step's prefetch and compute proceed.

    PYTHONPATH=src python -m repro_torch.examples.io_overlap_demo \
        [--device cpu] [--steps 15] [--d-model 384]

The port's ``save`` copies every leaf to the host before it returns (the
train step updates the state in place), so both legs pay that snapshot
in the loop; the writes and fsyncs are what UMT overlaps.  Checkpoints go
to a temporary directory.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get
from ..core import UMTRuntime
from ..data import SyntheticTokenSource, UMTPrefetcher
from ..device import resolve_device
from ..optim import OptHParams
from ..steps import init_train_state, make_train_step


def run(cfg, steps, umt: bool, sync_saves: bool, device) -> float:
    state = init_train_state(cfg, torch.Generator(device).manual_seed(0),
                             device=device)
    step_fn = make_train_step(cfg, OptHParams(warmup=5))
    src = SyntheticTokenSource(seed=3, batch=8, seq=64, vocab=cfg.vocab)
    with tempfile.TemporaryDirectory(prefix="io_overlap_") as ckpt, \
            UMTRuntime(n_cores=2, umt=umt) as rt:
        mgr = CheckpointManager(ckpt, rt=None if sync_saves else rt)
        pf = UMTPrefetcher(src, rt, depth=2)
        # warm-up (kernel builds, first launches) outside the timed region
        state, m = step_fn(state, pf.get(0))
        float(m["loss"])
        t0 = time.monotonic()
        for step in range(1, steps):
            state, _ = step_fn(state, pf.get(step))
            mgr.save(state, step, wait=sync_saves)   # ckpt EVERY step
        mgr.wait()
        return time.monotonic() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--d-model", type=int, default=384,
                    help="the reference's 384: a full-state checkpoint of "
                         "about 160 MB, fsync'd, costs about one step")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    d = args.d_model
    cfg = get("qwen2.5-14b").tiny(d_model=d, d_ff=4 * d, vocab=16384,
                                  head_dim=d // 8)
    base = run(cfg, args.steps, umt=False, sync_saves=True, device=device)
    umt = run(cfg, args.steps, umt=True, sync_saves=False, device=device)
    print(f"baseline (sync ckpt):   {base:.2f}s for {args.steps - 1} steps")
    print(f"UMT (overlapped ckpt):  {umt:.2f}s for {args.steps - 1} steps")
    print(f"speedup: {base / umt - 1:+.1%}")
    return {"sync_s": base, "umt_s": umt}


if __name__ == "__main__":
    main()
