"""Quickstart: the two halves of this framework (port of
``examples/quickstart.py``).

1. The UMT runtime (the paper): blocking I/O in one task frees the core
   for another — watch the wall clock.
2. The port: train a tiny assigned-architecture model a few steps on the
   card.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get
from ..core import UMTRuntime, io
from ..data import SyntheticTokenSource
from ..device import resolve_device
from ..optim import OptHParams
from ..steps import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    # ---- 1. UMT in one picture ---------------------------------------
    print("== UMT: overlapping blocking I/O on one core ==")
    walls = {}
    for umt in (False, True):
        t0 = time.monotonic()
        with UMTRuntime(n_cores=1, umt=umt) as rt:
            for _ in range(4):
                rt.submit(lambda: io.sleep(0.2))   # a blocking "I/O" op
            rt.wait_all()
        walls[umt] = time.monotonic() - t0
        print(f"  umt={umt}:  4 x 0.2s blocking ops -> {walls[umt]:.2f}s "
              "wall")

    # ---- 2. Train a tiny model ---------------------------------------
    print(f"== training a tiny mixtral-family model on {device} ==")
    cfg = get("mixtral-8x7b").tiny()
    state = init_train_state(cfg, torch.Generator(device).manual_seed(0),
                             device=device)
    step = make_train_step(cfg, OptHParams(warmup=5))
    src = SyntheticTokenSource(seed=7, batch=4, seq=32, vocab=cfg.vocab,
                               accum=2)
    losses = []
    for i in range(10):
        state, metrics = step(state, src.fetch(i))
        losses.append(float(metrics["loss"]))
        if i % 3 == 0:
            print(f"  step {i}: loss {losses[-1]:.4f}")
    print("done — see repro_torch.examples.train_100m for the end-to-end "
          "driver")
    return {"umt_off_s": walls[False], "umt_on_s": walls[True],
            "losses": losses}


if __name__ == "__main__":
    main()
