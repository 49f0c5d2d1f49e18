#!/usr/bin/env python3
"""Time the bf16 kernels of two or more source trees on one NVIDIA card,
at the main paths' shapes: flash-attention prefill (qwen2.5-14b,
mixtral-8x7b), the SSD chunk scan (mamba2-780m's 1 x 2048 prefill, B and
C in the model's own layout), the paged MLA decode (minicpm3-4b's decode
tick) and the SSD scan's backward (mamba2-780m's 4 x 1024 train
microbatch and jamba-v0.1-52b's 1 x 2048, in the model's layout).

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
bf16; the SSD backward's five gradients row by row against the tree's
plain backward in f32 from the same inputs, ``chip_smoke.SSD_ROW_TOL``),
then timed with ``chip_smoke.time_ms`` (median of five 20-call CUDA-event
windows; five 5-call windows for the backward, with its device time
alone from ``chip_smoke.device_ms``).  Prints the card's name and power
limit, then one JSON line per reading.
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
# the SSD backward's (B, S, H, P, N, chunk)
BWD_SHAPES = {"mamba2 4x1024": (4, 1024, 48, 64, 128, 256),
              "jamba 1x2048": (1, 2048, 128, 64, 16, 256)}


def one(tree):
    """Check and time one tree's kernels; one JSON line per shape."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as smoke

    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch import kernels

    def report(name, ms, **more):
        print(json.dumps({"tree": tree, "shape": name, "ms": ms, **more}),
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
    del args
    ssd_bwd(tree, smoke, kernels, report)


def ssd_bwd(tree, smoke, kernels, report):
    """The SSD backward in the model's layout as training calls it (no
    dh_final), held row by row to the tree's plain backward in f32."""
    import torch

    kern, plain = kernels.ssd_scan_bwd, kernels.ssd_scan_bwd_ref
    for name, shape in BWD_SHAPES.items():
        b, s, h, p, n, chunk = shape
        leaves, dy, _ = smoke.ssd_grad_case(b, s, h, p, n, torch.bfloat16,
                                            seed=3)
        args = smoke.ssd_views(*leaves, h, p, n)
        got = kern(*args, dy, chunk=chunk)
        want = plain(*(t.float() for t in args), dy.float(), chunk=chunk)
        for k, g, w in zip(("dx", "ddt", "da", "dB", "dC"), got, want):
            if k == "da":                   # one row
                g, w = g[None], w[None]
            rms, worst = smoke.row_rel(g, w)
            tol = smoke.SSD_ROW_TOL
            if rms > tol["rms"] or worst > tol["worst"]:
                raise AssertionError(f"{tree} ssd_bwd {name} {k}: rows RMS "
                                     f"{rms:.3e} / worst {worst:.3e} "
                                     f"outside {tol}")
        del got, want
        torch.cuda.empty_cache()
        report(f"ssd_bwd {name}",
               smoke.time_ms(lambda: kern(*args, dy, chunk=chunk), iters=5),
               device_ms=smoke.device_ms(
                   lambda: kern(*args, dy, chunk=chunk), iters=5, lead=4))
        del args, leaves, dy


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
