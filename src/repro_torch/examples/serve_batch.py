"""Serve a small model two ways and compare (port of
``examples/serve_batch.py``):

  * ``oneshot`` — prefill one static batch of padded prompts, decode the
    whole batch to completion (the pre-engine path);
  * ``engine``  — continuous batching on the UMT runtime: requests arrive
    over time, are prefilled and inserted into free slots while decode
    keeps running, and finished sequences free their slot immediately.

Any given request's greedy tokens are the same under both paths (the
engine run below serves more requests than the one-shot batch, so the
printed samples differ; tests/test_torch_engine.py holds the engine to
the one-shot path request by request).

    PYTHONPATH=src python -m repro_torch.examples.serve_batch \
        [--arch jamba-v0.1-52b] [--device cpu]

The engine's flags are ``python -m repro_torch.launch.serve``'s, as in
the reference (``--page-size``, ``--pages``, ``--policy``,
``--prefix-cache``, ``--paged-kernel``, ``--spec``, ``--chunk``,
``--no-umt``); ``--mesh`` (tensor parallelism) is not ported yet.
"""
from __future__ import annotations

import argparse

from ..launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-v0.1-52b",
                    help="any assigned architecture (tiny variant is used)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    common = ["--arch", args.arch, "--tiny", "--batch", "4",
              "--prompt-len", "24", "--gen", "12", "--device", args.device]
    oneshot = serve(common + ["--mode", "oneshot"])
    engine = serve(common + ["--mode", "engine", "--requests", "8",
                             "--arrival-ms", "20"])
    return oneshot, engine


if __name__ == "__main__":
    main()
