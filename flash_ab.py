#!/usr/bin/env python3
"""Time the bf16 kernels of two or more source trees on one NVIDIA card,
at the serve paths' shapes: flash-attention prefill (qwen2.5-14b,
mixtral-8x7b), the SSD chunk scan (mamba2-780m's 1 x 2048 prefill, B and
C in the model's own layout) and the paged MLA decode (minicpm3-4b's
decode tick).

    python3 flash_ab.py TREE [TREE ...]

Each TREE is a checkout of this repository (for an earlier commit:
``git archive <commit> | tar -x -C build/<name>``).  Its
``src/repro_torch`` is imported in a process of its own, which builds
the tree's kernels into ``TREE/build``.  The trees run in the order given
and then in reverse (A B B A for two), so a drift of the card's clocks
over the call shows as a gap between one tree's two readings.

Per tree and shape, the kernel's output is first held to the tree's plain
version (flash and MLA row by row, ``chip_smoke.ROW_TOL``; the SSD scan
elementwise, ``chip_smoke.SSD_TOL``, as every tree's plain version is
bf16), then timed with ``chip_smoke.time_ms`` (median of five 20-call
CUDA-event windows).  Prints the card's name and power limit, then one
JSON line per reading.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = {"qwen 1x2048": ((1, 2048, 2048, 40, 8, 128), None),
          "qwen 16x512": ((16, 512, 512, 40, 8, 128), None),
          "mixtral 1x8192": ((1, 8192, 8192, 32, 8, 128), 4096)}


def one(tree):
    """Check and time one tree's kernels; one JSON line per shape."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as smoke

    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch import kernels

    def report(name, ms):
        print(json.dumps({"tree": tree, "shape": name, "ms": ms}),
              flush=True)

    kern, plain = kernels.flash_attention, kernels.flash_attention_ref
    for name, (shape, w) in SHAPES.items():
        q, k, v = smoke.flash_case(*shape, torch.bfloat16, seed=0)
        smoke.rows_close(kern(q, k, v, window=w), plain(q, k, v, window=w),
                         f"{tree} {name}")
        report(f"flash {name}", smoke.time_ms(lambda: kern(q, k, v,
                                                           window=w)))
        del q, k, v
        torch.cuda.empty_cache()

    kern, plain = kernels.ssd_scan, kernels.ssd_scan_ref
    args = smoke.ssd_model_layout(1, 2048, 48, 64, 128, torch.bfloat16,
                                  seed=1)
    smoke.close(kern(*args, chunk=256)[0], plain(*args, chunk=256)[0],
                torch.bfloat16, f"{tree} ssd", smoke.SSD_TOL)
    report("ssd mamba2 1x2048", smoke.time_ms(lambda: kern(*args,
                                                           chunk=256)))

    kern = kernels.paged_mla_decode_attention
    plain = kernels.paged_mla_decode_attention_ref
    args = smoke.mla_case(16, 40, 256, 32, 2080, 8, torch.bfloat16, seed=1,
                          pos=smoke.decode_pos())
    kw = dict(page_size=8, scale=(64 + 32) ** -0.5)
    smoke.rows_close(kern(*args, **kw), plain(*args, **kw), f"{tree} mla")
    report("mla minicpm3 decode", smoke.time_ms(lambda: kern(*args, **kw)))


def main(argv):
    if argv[:1] == ["--one"]:
        one(argv[1])
        return 0
    if not argv:
        raise SystemExit(__doc__)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    print(smoke.card(), flush=True)
    rc = 0
    for tree in argv + argv[::-1]:
        rc |= subprocess.run([sys.executable, __file__, "--one", tree],
                             timeout=600).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
