"""End-to-end driver: train a ~100M-parameter qwen2.5-family model with
the full production stack — UMT host runtime, prefetching data pipeline,
async fault-tolerant checkpointing, heartbeats, resume (port of
``examples/train_100m.py``, through ``repro_torch.launch.train``).

    PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300]

(~100M params: d_model 512, 16 layers, d_ff 2048, vocab 32000 -> 92M.
Kill/restart with the same command to exercise resume.)  Any other flag
is handed to the train CLI after the example's own, so it overrides
them (``--device cpu``, ``--log-every 1``, ``--umt-off``, a smaller
model for a quick look: ``--d-model 64 --n-layers 2 --vocab 256``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    args, rest = ap.parse_known_args(argv)
    return train([
        "--arch", "qwen2.5-14b", "--tiny",
        "--d-model", "512", "--n-layers", "16", "--vocab", "32000",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "25",
        "--resume",
        "--log-every", "10",
    ] + rest)


if __name__ == "__main__":
    main()
