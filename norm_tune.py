#!/usr/bin/env python3
"""Tune and time the given-statistic RMSNorm backward (tensor parallelism's
gated norm in training: ``rms_norm_dot`` then ``rms_norm_bwd_rstd``, the
two Triton passes of ``src/repro_torch/kernels/rmsnorm/kernel.py``) on one
NVIDIA card, at mamba2-780m's gated-norm shapes of the TP train path: a
microbatch of 4 x 1024 rows of d_inner 3072, one rank's columns at model 2
(1536) and at model 4 (768), bf16.

    python3 norm_tune.py [--quick]

For each shape: every launch configuration of a grid, pass 1's
(``rows``, ``warps``, ``stages``, ``per_sm``) with pass 2 at its default,
then pass 2's (``rows2``, ``warps2``, the dw strips' ``strip`` and
``block_p``) with pass 1 at its best; each configuration first held to
the plain version (dx by ``chip_smoke.TOL``, dw by ``chip_smoke.DW_TOL``),
then timed by the profiler over rotating copies of its inputs
(``chip_smoke.rotated``: each call's x and dy last read two L2-fulls
ago), each pass's device time apart.  Then, for the best: pass 2 alone
with no pass 1 before it (x and dy from HBM), which shows what reading
them from L2 saves.  Then the module's defaults (``kernel.given_plan``):
the host's time a call (CUDA events around host-bound loops: the
wrappers, the bare launches) with a cProfile of the wrappers, and the
wrappers' device time by the profiler and time by CUDA events.  Last,
the plain RMSNorm backward (``rms_norm_bwd``) at its training shape,
(4096, 5120).  A configuration the card refuses (shared memory) is
reported and skipped.  ``--quick`` runs a few configurations only.
Prints the card's name and power limit, then one JSON line per reading.
"""
from __future__ import annotations

import cProfile
import io
import itertools
import pstats
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ROWS, WIDTH, EPS = 4096, 3072, 1e-5
SHAPES = {"2r mamba2 (4096, 1536)": 2, "4r mamba2 (4096, 768)": 4}
GRID1 = dict(rows=(1, 2, 4, 8), warps=(1, 2, 4, 8), stages=(2, 3),
             per_sm=(1, 2, 4, 8))
TILE_MAX = 32768        # the bytes of x a tile holds, at most
GRID2 = dict(rows2=(1, 2, 4), warps2=(4, 8), strip=(16, 32),
             block_p=(64, 256))


def main(quick):
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import (rms_norm_bwd, rms_norm_bwd_ref,
                                     rms_norm_bwd_rstd, rms_norm_dot)
    from repro_torch.kernels.rmsnorm import kernel as rk

    def say(obj):
        print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)

    import triton
    say(smoke.card())
    say(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} triton {triton.__version__}")
    sms = rk.sm_count("cuda")
    rng = torch.Generator(device="cuda").manual_seed(11)
    bf16 = torch.bfloat16
    x = torch.randn(ROWS, WIDTH, device="cuda", generator=rng)
    dy = (0.5 * x + torch.randn(ROWS, WIDTH, device="cuda",
                                generator=rng)).to(bf16)
    x = x.to(bf16)
    w = (torch.randn(WIDTH, device="cuda", generator=rng) * 0.1
         + 1.0).to(bf16)
    rstd = torch.rsqrt(x.float().square().mean(-1) + EPS)
    pdx, pdw = rms_norm_bwd_ref(x, w, dy, EPS)
    s_all = (x.float() * w.float() * dy.float()).sum(-1)

    for shape, ranks in SHAPES.items():
        cut = WIDTH // ranks
        args = (x[:, :cut].contiguous(), w[:cut].contiguous(),
                dy[:, :cut].contiguous(), rstd)
        nbytes = 3 * args[0].numel() * 2 + 2 * cut * 2 + ROWS * 4 * 3
        bound = nbytes / smoke.HBM_BPS * 1e3
        bound2 = (nbytes + 2 * args[0].numel() * 2) / smoke.HBM_BPS * 1e3
        say({"shape": shape, "bound_ms": bound, "bound_two_reads_ms": bound2,
             "sms": sms})

        def two_pass(plan, first=True):
            def f(a, b, c, r):
                s = torch.empty(ROWS, dtype=torch.float32, device="cuda")
                parts = torch.empty((plan["programs"], cut),
                                    dtype=torch.float32, device="cuda")
                if first:
                    rk.launch_dot(a, b, c, r, s, parts, plan)
                dx = torch.empty_like(a)
                dw = torch.empty(cut, dtype=bf16, device="cuda")
                rk.launch_dx(a, b, c, r, s_all, WIDTH, dx, dw, parts, plan)
                return dx, dw
            return f

        def held(plan):
            dx, dw = two_pass(plan)(*args)
            smoke.close(dx, pdx[:, :cut], bf16, f"{shape} {plan} dx")
            rel = ((dw.float() - pdw[:cut].float()).norm()
                   / pdw[:cut].float().norm()).item()
            if rel > smoke.DW_TOL["bfloat16"]:
                raise AssertionError(f"{shape} {plan}: dw rel {rel:.3e}")

        def timed(plan, first=True):
            """(pass 1 ms, pass 2 ms) of device time a call (a second
            trace where the first missed a launch)."""
            rot, _ = smoke.rotated(two_pass(plan, first), args, nbytes)
            ms = (smoke.device_ms_by_kernel(rot, lead=8)
                  or smoke.device_ms_by_kernel(rot, lead=8))
            if ms is None:
                raise RuntimeError("the profiler missed launches")
            return (ms.get("rms_norm_dot_dw", 0.0),
                    ms["rms_norm_dx_given"])

        def sweep(grid, base):
            best = None
            keys = list(grid)
            combos = list(itertools.product(*grid.values()))
            if quick:
                combos = combos[::max(1, len(combos) // 6)]
            for values in combos:
                over = dict(base, **dict(zip(keys, values)))
                plan = rk.given_plan(ROWS, cut, 2, sms, **over)
                block = triton.next_power_of_2(cut)
                if max(plan["rows"], plan["rows2"]) * block * 2 > TILE_MAX:
                    continue
                try:
                    held(plan)
                    pass1, pass2 = timed(plan)
                except Exception as e:          # refused by the card
                    if isinstance(e, AssertionError):
                        raise
                    say({"shape": shape, "plan": plan,
                         "refused": f"{type(e).__name__}: {str(e)[:160]}"})
                    continue
                say({"shape": shape, "plan": plan, "pass1_ms": pass1,
                     "pass2_ms": pass2, "total_ms": pass1 + pass2})
                score = pass1 if "rows" in grid else pass2
                if best is None or score < best[0]:
                    best = (score, over)
            return best[1]

        best1 = sweep(GRID1, {})
        say({"shape": shape, "best_pass1": best1})
        best2 = sweep(GRID2, best1)
        say({"shape": shape, "best": best2})
        # the best and the defaults, each with pass 2 alone beside it
        for name, over in (("best", best2), ("default", {})):
            plan = rk.given_plan(ROWS, cut, 2, sms, **over)
            both = timed(plan)
            say({"shape": shape, "which": name, "plan": plan,
                 "pass1_ms": both[0], "pass2_after_pass1_ms": both[1],
                 "pass2_alone_from_hbm_ms": timed(plan, first=False)[1]})

        # the host's enqueue a call (CUDA events around a host-bound
        # loop): the wrappers, the two launches alone, each alone
        def wrappers(a, b, c, r):
            s, parts = rms_norm_dot(a, b, c, r)
            return rms_norm_bwd_rstd(a, b, c, r, s, WIDTH, parts)

        a, b, c, r = args
        s_out = torch.empty(ROWS, dtype=torch.float32, device="cuda")
        parts = torch.empty((plan["programs"], cut), dtype=torch.float32,
                            device="cuda")
        dx, dw = torch.empty_like(a), torch.empty(cut, dtype=bf16,
                                                  device="cuda")
        say({"shape": shape, "host": {
            "wrappers_ms": smoke.time_ms(lambda: wrappers(*args)),
            "launches_ms": smoke.time_ms(lambda: (
                rk.launch_dot(a, b, c, r, s_out, parts, plan),
                rk.launch_dx(a, b, c, r, s_all, WIDTH, dx, dw, parts,
                             plan))),
            "launch_dot_ms": smoke.time_ms(lambda: rk.launch_dot(
                a, b, c, r, s_out, parts, plan)),
            "launch_dx_ms": smoke.time_ms(lambda: rk.launch_dx(
                a, b, c, r, s_all, WIDTH, dx, dw, parts, plan))}})
        # where the wrappers' host time goes (cProfile's own cost in)
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(2000):
            wrappers(*args)
        prof.disable()
        torch.cuda.synchronize()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(18)
        say(text.getvalue())

        # the defaults through the wrappers: profiler and events
        rot, n_rot = smoke.rotated(wrappers, args, nbytes)
        dev = smoke.device_ms(rot, per_call=2, lead=8)
        ev = smoke.time_ms(rot)
        say({"shape": shape, "wrappers_device_ms": dev, "events_ms": ev,
             "copies": n_rot, "share_one_read": dev and bound / dev,
             "share_two_reads": dev and bound2 / dev})

    # the plain RMSNorm backward at its training shape, for its row
    xb = torch.randn(4096, 5120, device="cuda", generator=rng)
    dyb = (0.5 * xb + torch.randn(4096, 5120, device="cuda",
                                  generator=rng)).to(bf16)
    xb = xb.to(bf16)
    wb = (torch.randn(5120, device="cuda", generator=rng) * 0.1
          + 1.0).to(bf16)
    rb = torch.rsqrt(xb.float().square().mean(-1) + EPS)
    say({"shape": "rms_norm_bwd (4096, 5120) bf16",
         "device_ms": smoke.device_ms(lambda: rms_norm_bwd(xb, wb, dyb, rb),
                                      per_call=2, lead=8),
         "events_ms": smoke.time_ms(lambda: rms_norm_bwd(xb, wb, dyb, rb))})
    say(smoke.card())


if __name__ == "__main__":
    main("--quick" in sys.argv[1:])
