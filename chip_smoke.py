#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # the whole run, from a checkout
    python3 chip_smoke.py --layers 8   # cut every phase's depth (width is
                                       # never cut)

Phases (each raises on failure, so the script exits non-zero):

1. card   — requires ``torch.cuda.is_available()``; prints
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. build  — builds the four CUDA libraries from ``src/repro_torch/csrc``
   with ``nvcc`` (sm_90a), one ``nvcc`` per source, all started together,
   then the Triton kernel; prints the seconds and ``ptxas``' register and
   spill lines.
3. kernels — each kernel's wrapper against its plain PyTorch version on
   the card: paged GQA decode at qwen2.5-14b decode shapes and paged MLA
   decode at minicpm3-4b's (each: its split boundaries, its combine
   kernel against the plain combine on the split kernel's own partials,
   bf16 held row by row, and two planted faults the row check must
   reject), the SSD scan at mamba2-780m's prefill shapes (batch 1 and 16;
   B and C also in the model's own layout, one group read in place; bf16
   y held row by row against the plain version in f32, and a planted
   fault between its phases the row check must reject), flash attention
   at qwen2.5-14b's (1 x 2048, 16 x 512) and mixtral-8x7b's prefill
   shapes, RMSNorm, each with the edge cases of the reference's kernel
   tests; then CUDA-event times of kernel, plain version and one PyTorch
   library call where there is one, beside the least time the card could
   take (``bound_ms``); for the paged decodes and the SSD scan, also the
   device time alone (``torch.profiler``), where the trace holds every
   launch.
4. serve  — the port's main paths at full width, one after the other,
   each behind ``repro_torch.serve.ServeEngine`` on the UMT runtime with
   seeded bf16 weights made on the card by the engine's weights task:
   qwen2.5-14b (paged, ``paged_kernel=True``, flash prefill), minicpm3-4b
   (MLA, paged, ``paged_kernel=True``), mamba2-780m (SSD,
   ``page_size="auto"``) at full depth, each with 32 requests with prompt
   lengths from {256, 512, 1024, 2048} and 16 slots; then mixtral-8x7b
   (MoE, sliding-window rings, flash prefill) at 16 of its 32 layers (the
   whole model does not fit one card), 16 requests, each prompt length of
   {1024, 2048, 6144, 8192} four times, 8 slots.  32 tokens each,
   staggered arrivals.  Launch counters are zeroed right before each
   phase and read right after; each phase's identities are checked.  Then
   the teacher-forced checks: one forward of the port over prompt +
   emitted tokens must put each emitted token at (or within ``LOGIT_TOL``
   of) its argmax, and the engine's step path fed the same tokens must
   give that forward's logits within ``REL_TOL`` at every position —
   while each fault planted in that path (``PLANTED``) must fail both
   checks.  The forward of the checks runs plain attention
   (``full_attention`` with the true window mask) and mamba2's the plain
   SSD scan, so a fault of a kernel or of the ring cannot sit on both
   sides; mamba2's conv weights are scaled up (``SSM_CONV_W_GAIN``, the
   reason beside it) so that a fault of the scan or state can show at
   all; mixtral's forward takes the expert ids the step path picked (the
   reason is in ``serve``) and computes everything else itself, while
   the route check holds those ids to the forward's own wherever its
   choice is clear (``ROUTE_MARGIN``, ``ROUTE_MARGIN_FIRST``), and the
   registry's capacity MoE dispatch, which the phase does not serve, is
   held at mixtral's layer shape against its rule
   (``check_capacity_dispatch``).
5. summary — one ``kernels`` JSON line, then the ``ok`` line.

Nothing of JAX or of the ``repro`` package is imported.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# the reference's kernel-test tolerances (tests/test_kernels.py:15-17;
# the SSD scan's :220-221: its plain version rounds its intermediates to
# bf16 where the kernel sums in f32)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SSD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=4e-2, atol=4e-2)}
# Flash attention in bf16, row by row: the error of each (b, s, h) output
# row over that row's norm.  TOL's bf16 2e-2 is as large as a typical
# output value of a row that attends over thousands of keys (about
# sqrt(e / n) for N(0, 1) inputs: 0.026 at mixtral's window of 4096), so
# at the serve shapes it could not see a key tile left out.  The kernel's
# own error is bf16 rounding (P before the P.V product, the output), a
# few 1e-3 of a row's norm; a row missing one 64-key tile of 4096 is off
# by about 0.12.  Bounds: the RMS over rows and the worst row.  The
# capacity MoE dispatch is held to the same row bounds
# (``check_capacity_dispatch``).
ROW_TOL = dict(rms=1e-2, worst=5e-2)
# The SSD scan in bf16, row by row: each (b, s, h) row of y against the
# plain version computed in f32 from the same bf16 inputs.  SSD_TOL's
# bf16 4e-2 holds the kernel against the plain version in bf16, whose own
# intermediates round to bf16; here the kernel's error alone is held.
# Its bf16 roundings: x * w in the chunk states, the state entering a
# chunk, the decay-weighted C B^T (P before P.V, as in attention) and y
# itself, each a relative error up to 2^-8 (RMS about 1.1e-3), about
# 2.5e-3 of a row's norm for four in a chain; a row's 64 values average
# the rest.  So the bounds of ROW_TOL (RMS 1e-2, worst row 5e-2) leave a
# factor of 4 at the RMS.  A row that loses the cross-chunk term (the
# planted fault: one chunk's state not handed on) is off by about its
# whole norm in the first ~30 rows of the chunk, RMS over rows above
# 0.05.
SSD_ROW_TOL = dict(rms=1e-2, worst=5e-2)
# Token check: an emitted token may trail the teacher-forced forward's
# argmax by at most this many logit units.  The engine's tokens come from
# a qchunk prefill plus paged-kernel decode ticks (f32 softmax inside the
# kernel), the check's from one full-attention forward (scores rounded to
# bf16 before the softmax); both carry a bf16 residual stream through 48
# layers, so near-ties flip.  On an H100 (qwen2.5-14b, 48 layers) the
# random-weight model's logits have a standard deviation of about 1.4, a
# median top-two margin of about 0.22, and emitted tokens trail by at most
# 0.56; the argmax of each planted fault below trails by 9 or more.
LOGIT_TOL = 1.0
# Logit check: the engine's step path (prefill step, paged insert,
# paged-kernel decode), teacher-forced with the engine's tokens, against
# the forward's logits at each position: ||path - fwd|| over
# ||fwd - mean(fwd)||.  On an H100 the worst position reads about 0.14
# (independent bf16 rounding in the two paths); each planted fault moves
# some position past 1.3, as far as an unrelated model would.
REL_TOL = 0.3
# Faults planted in each phase's path as controls: each must fail both
# the token check and the logit check, or the checks prove nothing.  The
# SSD faults act in the prefill (the scan and the state it hands over) or
# in the decode recurrence; the paged attention faults in the decode
# tick; mixtral's in the flash prefill (query head h reads kv head
# h % Hkv), in the MoE (the second pick's weight dropped, prefill and
# decode) and in the ring a prefill hands decode (the reference's
# placement: the last ``ring`` positions unrolled, wrong for a prompt past
# the window and no multiple of it — 6144 here).
PLANTED = {
    "qwen2.5-14b": ("rope_pos_plus_1", "kv_group_order", "slot_pos_rolled",
                    "newest_kv_left_out"),
    "minicpm3-4b": ("rope_pos_plus_1", "slot_pos_rolled",
                    "newest_kv_left_out", "q_rope_next_head"),
    "mamba2-780m": ("state_not_handed", "dt_one_late", "conv_tail_rolled"),
    "mixtral-8x7b": ("flash_kv_group_order", "moe_second_pick_dropped",
                     "ring_not_rolled"),
}
# mixtral's teacher-forced forward takes the expert ids of the step path
# (the reason is in ``serve``), so a wrong top-k on the card would sit on
# both sides of the logit checks.  The route check holds it: wherever the
# forward's own k-th and (k+1)-th router probabilities lie more than a
# bound apart, the path must have picked the forward's own top-k set.  At
# random init bf16 rounding differences between the two computations grow
# through the layers (the logits of a position differ by up to 0.13 of
# their spread) and flip picks at wide margins too: on an H100 the widest
# margin of a flip read 0.1492 over 1,122,048 (layer, position) pairs, p99
# 0.0562, and 1096 pairs above 0.05 differed.  The bound is twice the
# widest; about 1 % of the pairs lie above it.  In the first MoE layer the
# two computations differ only by one attention layer and its widest flip
# read 0.0107, so there the bound is 0.03 and covers most positions.
# ``ROUTE_FAULTS`` are planted in the routing itself, so that the forward
# takes the faulty ids too: each must fail the route check.
ROUTE_MARGIN = 0.3
ROUTE_MARGIN_FIRST = 0.03
ROUTE_FAULTS = ("moe_ids_permuted",)
PREFILL_FAULTS = ("state_not_handed", "dt_one_late", "flash_kv_group_order",
                  "moe_second_pick_dropped", "ring_not_rolled")
# The SSM phase's conv weights are scaled by this gain from the repo's
# normal 0.02 to std 1.0, so that the checks can see a fault of the scan
# or of the state.  At 0.02 the depthwise conv (fan-in 4) outputs x, B
# and C of about 0.016, so C.B is about 0.003 and the SSD scan adds about
# 1e-5 of D*x to each mixer's output: the state faults then move the
# logits no more than bf16 noise does.  Every other leaf keeps the repo's
# init.
SSM_CONV_W_GAIN = 50.0
# Traffic of a phase: slots, cache_len, prompt lengths (drawn at random,
# or ``each`` length n_req / len(lens) times in a seeded order), requests,
# tokens per request.
TRAFFIC = dict(slots=16, cache_len=2080, lens=(256, 512, 1024, 2048),
               each=False, n_req=32, gen=32)
# mixtral-8x7b: prompts inside the 4096 window, at multiples of it, and
# past it but no multiple (the ring's hard case); cache_len holds the
# longest prompt + 32 tokens
MIXTRAL_TRAFFIC = dict(slots=8, cache_len=8224, lens=(1024, 2048, 6144, 8192),
                       each=True, n_req=16, gen=32)
# Per phase: decode attention through its paged kernel?  For each kernel
# of the phase, the engine count its launches follow once per layer
# (decode dispatches or prefill calls; None: no launch at all — mixtral's
# attention leaves are rings, which decode reads without the paged
# kernel, as the reference does); RMSNorm launches per layer of each tick
# and prefill call (+ the final norm); the traffic; the depth cut.
PHASES = {
    "qwen2.5-14b": dict(paged_kernel=True, norms=2, traffic=TRAFFIC,
                        kernels={"paged_decode_attention": "decode_dispatches",
                                 "flash_attention": "prefill_calls"}),
    "minicpm3-4b": dict(paged_kernel=True, norms=4, traffic=TRAFFIC,
                        kernels={"paged_mla_decode_attention":
                                 "decode_dispatches"}),
    "mamba2-780m": dict(paged_kernel=False, norms=2, traffic=TRAFFIC,
                        kernels={"ssd_scan": "prefill_calls"}),
    # 16 of 32 layers: full depth is 93.4 GB of bf16 weights, more than
    # the card holds; 16 layers are 46.4 GB + 0.5 GB of embedding and head.
    # The dropless MoE dispatch, as Mixtral is served: at this init the
    # capacity dispatch (the registry's default) drops some (token, pick)
    # pairs of every long prompt, and which ones depends on the sequence
    # length — so prefill + decode and the checks' one forward over prompt
    # + tokens would differ by construction (``check_capacity_dispatch``
    # holds that dispatch on the card).
    "mixtral-8x7b": dict(paged_kernel=True, norms=2, traffic=MIXTRAL_TRAFFIC,
                         layers=16, moe_impl="ragged",
                         kernels={"flash_attention": "prefill_calls",
                                  "paged_decode_attention": None}),
}


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ helpers
def card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this run needs an NVIDIA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {ROOT} is not a checkout of the "
                         "repository (src/repro_torch is missing)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return smi


def time_ms(fn, iters=20, warmup=5, reps=5):
    """Median over ``reps`` batches of ``iters`` calls, CUDA events around
    each batch: one slow batch (clocks still ramping, a neighbour on the
    host) does not decide the number."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def device_ms(fn, iters=20, per_call=None):
    """Device time per call: the kernels' time in a ``torch.profiler``
    trace of ``iters`` calls after warm-up, summed over every kernel the
    call launches.  Unlike ``time_ms`` it leaves out the host's time to
    enqueue, which on a slow host exceeds a short kernel's.  The trace
    must hold every launch, or the sum would read low: one more call runs
    first inside the trace (the profiler can miss a window's first
    launch), and of each kernel name, launched k times a call, the last
    k * ``iters`` launches are summed, which the trace must hold — each
    with a duration, and ``per_call`` kernels a call where the caller
    knows the number.  Otherwise it returns None (no device time)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters + 1):
            fn()
        torch.cuda.synchronize()
    by_name = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name].append(e)
    kernels, whole = [], bool(by_name)
    for evs in by_name.values():
        k = -(-len(evs) // (iters + 1))          # launches of it per call
        whole &= len(evs) >= k * (iters + 1) - 1
        kernels += sorted(evs, key=lambda e: e.time_range.start)[
            -k * iters:]
    whole = (whole and all(e.time_range.elapsed_us() > 0 for e in kernels)
             and (per_call is None or len(kernels) == per_call * iters))
    if not whole:
        counts = {k: len(v) for k, v in by_name.items()}
        log(f"device_ms: the trace does not hold every launch of the last "
            f"{iters} of {iters + 1} calls ({counts}); no device time")
        return None
    by_kernel = collections.Counter()
    for e in kernels:      # "void (anonymous namespace)::f<T>(args)" -> f<T>
        name = e.name.replace("(anonymous namespace)::", "")
        by_kernel[name.split("(")[0].split()[-1]] += e.time_range.elapsed_us()
    log("  device ms per call by kernel: " + ", ".join(
        f"{k} {v / iters / 1e3:.4f}" for k, v in by_kernel.items()))
    return sum(e.time_range.elapsed_us() for e in kernels) / iters / 1e3


def ms_text(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def clocks():
    """SM clock, power draw and temperature right now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def close(got, want, dtype, what, tols=TOL):
    import torch

    tol = tols[str(dtype).replace("torch.", "")]
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"{what}: kernel vs plain max |err| {err:.3e} "
                             f"outside rtol/atol {tol['rtol']}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    return err


# ------------------------------------------------------------ paged decode
def held_rows(got, want, dt, what, rows_err):
    """A paged decode's output held to its plain version: elementwise TOL;
    in bf16 also the row bound ROW_TOL over each (slot, head) output row
    (into ``rows_err[what]``): at 2000 positions a typical output is about
    0.04, as large as TOL's 2e-2."""
    import torch

    err = close(got, want, dt, what)
    if dt == torch.bfloat16:
        rows_err[what] = rows_close(got, want, what)
    return err


def planted_rows(kernel, shape, faults, want, elementwise_tol):
    """Planted kernel faults: each output must fail the row check (ROW_TOL
    or the bound given); what the elementwise tolerance alone says of it
    is logged."""
    import torch

    for name, (got, tol) in faults.items():
        rms, worst = row_rel(got, want)
        elementwise = torch.allclose(got.float(), want.float(),
                                     **elementwise_tol)
        log(f"{kernel} planted fault ({name}, {shape}): row error RMS "
            f"{rms:.3e} / worst {worst:.3e}; elementwise tolerance alone "
            f"{'passes' if elementwise else 'rejects'} it")
        if rms <= tol["rms"] and worst <= tol["worst"]:
            raise AssertionError(f"{kernel}: the row check does not reject "
                                 f"the planted fault ({name})")


def decode_pos():
    """Ragged positions of 16 decode slots as in the serve phases: prompt
    lengths of ``TRAFFIC`` plus up to 31 generated tokens, slot 0 full."""
    import numpy as np

    rng = np.random.default_rng(0)
    pos = (rng.choice([256, 512, 1024, 2048], 16)
           + rng.integers(0, 32, 16) - 1)
    pos[0] = 2079
    return pos


def paged_table(b, cache_len, ps, pos, rng, garbage_rest=True):
    """Block table covering each slot's pos with shuffled physical pages;
    the rest on garbage page 0 (or allocated ahead of pos)."""
    import numpy as np

    pps = cache_len // ps
    num_pages = 1 + b * pps
    phys = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    table = np.zeros((b, pps), np.int32)
    nxt = 0
    for i in range(b):
        n = pps if not garbage_rest else -(-(int(pos[i]) + 1) // ps)
        table[i, :n] = phys[nxt:nxt + n]
        nxt += n
    return table, num_pages


def paged_case(b, h, hkv, dh, cache_len, ps, dtype, seed, window=None,
               pos=None, garbage_rest=True):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if pos is None:
        pos = rng.integers(0, cache_len, b)
        pos[0] = cache_len - 1
    pos = np.asarray(pos, np.int32)
    table, num_pages = paged_table(b, cache_len, ps, pos, rng, garbage_rest)
    dev = "cuda"
    q = torch.tensor(rng.standard_normal((b, 1, h, dh), np.float32),
                     device=dev).to(dtype)
    kp = torch.tensor(rng.standard_normal((num_pages, ps, hkv, dh),
                                          np.float32), device=dev).to(dtype)
    vp = torch.tensor(rng.standard_normal((num_pages, ps, hkv, dh),
                                          np.float32), device=dev).to(dtype)
    return (q, kp, vp, torch.tensor(table, device=dev),
            torch.tensor(pos, device=dev)), dict(page_size=ps, window=window)


def check_paged_decode():
    import numpy as np
    import torch

    from repro_torch.kernels.paged_attention import (
        paged_decode_attention as kern, paged_decode_attention_ref as plain)
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention import ref as paged_ref

    f32, bf16 = torch.float32, torch.bfloat16
    n = 0
    rows_err = {}

    def held(got, want, dt, what):
        return held_rows(got, want, dt, what, rows_err)

    # the reference's grid (tests/test_kernels.py:99-121) in both dtypes
    for dt in (f32, bf16):
        for shape in [(2, 4, 4, 32, 16, 4), (3, 8, 2, 64, 32, 8),
                      (2, 4, 1, 32, 16, 2), (2, 6, 3, 16, 12, 1),
                      (1, 2, 2, 32, 8, 8)]:
            args, kw = paged_case(*shape, dt, seed=7)
            held(kern(*args, **kw), plain(*args, **kw), dt,
                 f"paged grid {shape} {dt}")
            n += 1
        # every GQA group size in REGISTRY (1, 2, 4, 5, 6, 8, 12)
        for g in (1, 2, 4, 5, 6, 8, 12):
            for dh in (64, 128):
                args, kw = paged_case(3, 2 * g, 2, dh, 40, 8, dt, seed=g)
                held(kern(*args, **kw), plain(*args, **kw), dt,
                     f"paged group {g} dh {dh} {dt}")
                n += 1
    for dt in (f32, bf16):
        # windows (tests/test_kernels.py:123-137)
        for w in (1, 3, 7, 100):
            args, kw = paged_case(3, 4, 2, 32, 24, 4, dt, seed=8, window=w)
            held(kern(*args, **kw), plain(*args, **kw), dt,
                 f"window {w} {dt}")
            n += 1
        # poisoned garbage page must be inert (:165-182): bit-identical
        for w in (None, 3):
            args, kw = paged_case(3, 4, 2, 32, 16, 4, dt, seed=10,
                                  pos=[0, 5, 15], window=w)
            q, kp, vp, table, pos = args
            clean = kern(*args, **kw)
            kp2, vp2 = kp.clone(), vp.clone()
            kp2[0] = 1e4
            vp2[0] = 1e4
            poisoned = kern(q, kp2, vp2, table, pos, **kw)
            if not torch.equal(clean, poisoned) or \
                    not torch.isfinite(poisoned).all():
                raise AssertionError(f"garbage page leaked into the kernel "
                                     f"output ({dt}, window {w})")
            n += 1
        # allocated-but-future pages are masked (:185-201)
        args, kw = paged_case(2, 2, 2, 16, 16, 4, dt, seed=11, pos=[2, 9],
                              garbage_rest=False)
        held(kern(*args, **kw), plain(*args, **kw), dt,
             f"future pages {dt}")
        n += 1
    # split boundaries at qwen's width: positions at and around the split
    # length, a slot at 0, a window that empties whole splits
    n_split, split_len = paged_ops.split_plan(2080, 8)
    edge = [split_len - 2, split_len - 1, split_len, 0, 2079,
            2 * split_len - 1, 2 * split_len, 1]
    for dt in (f32, bf16):
        for w in (None, 100, split_len):
            args, kw = paged_case(8, 40, 8, 128, 2080, 8, dt, seed=12,
                                  pos=edge, window=w)
            held(kern(*args, **kw), plain(*args, **kw), dt,
                 f"split edges (n_split {n_split}, split_len "
                 f"{split_len}) window {w} {dt}")
            n += 1
    # the combine kernel against its plain version on the split kernel's
    # own partials (qwen's decode shape; these launches are not counted)
    comb_err = {}
    rng = np.random.default_rng(0)
    cpos = (rng.choice([256, 512, 1024, 2048], 16)
            + rng.integers(0, 32, 16) - 1)
    for dt in (f32, bf16):
        args, kw = paged_case(16, 40, 8, 128, 2080, 8, dt, seed=13,
                              pos=cpos, window=1000 if dt == f32 else None)
        ns, sl = paged_ops.split_plan(2080, 8)
        acc, m, l = paged_ops.paged_decode_partials(
            *args, n_split=ns, split_len=sl, **kw)
        comb_err[dt] = held(paged_ops.paged_decode_combine(acc, m, l, dt),
                            paged_ref.paged_decode_combine_ref(acc, m, l,
                                                               dt),
                            dt, f"combine {dt}")
        if not torch.equal(l == 0, m == -torch.inf):
            raise AssertionError("an empty split's partial is not "
                                 "(m = -inf, l = 0)")
        n += 1
    log(f"paged_decode combine: kernel vs plain on the split kernel's "
        f"partials ({ns} splits of {sl}) max|err| f32 {comb_err[f32]:.3e} "
        f"bf16 {comb_err[bf16]:.3e}")

    # qwen2.5-14b decode shapes: 16 slots, Hkv 8, group 5, Dh 128, ps 8,
    # cache_len 2080, ragged pos up to 2079 (prompt lengths of the serve
    # phase + up to 31 generated tokens)
    qpos = decode_pos()
    errs = {}
    for dt in (f32, bf16):
        args, kw = paged_case(16, 40, 8, 128, 2080, 8, dt, seed=1,
                              pos=qpos)
        errs[dt] = held(kern(*args, **kw), plain(*args, **kw), dt,
                        f"qwen shapes {dt}")
        n += 1
    worst = max(rows_err, key=lambda k: rows_err[k][1])
    log(f"paged_decode: {n} cases match the plain version "
        f"(f32 rtol/atol 2e-5, bf16 2e-2 and row error {ROW_TOL}); qwen "
        f"shapes max|err| f32 {errs[f32]:.3e} bf16 {errs[bf16]:.3e}; bf16 "
        f"row error RMS / worst: qwen shapes "
        f"{rows_err[f'qwen shapes {bf16}'][0]:.3e} / "
        f"{rows_err[f'qwen shapes {bf16}'][1]:.3e}, combine "
        f"{rows_err[f'combine {bf16}'][0]:.3e} / "
        f"{rows_err[f'combine {bf16}'][1]:.3e}; worst row of all bf16 "
        f"cases {rows_err[worst][1]:.3e} ({worst})")

    # planted kernel faults at qwen's decode shape in bf16: the last
    # 64-position tile of every slot left out (a bound one tile short),
    # and each row's last non-empty split dropped from the combine (on
    # the split kernel's own partials).  The row check must reject both;
    # what the elementwise bf16 tolerance says of each is logged.
    args, kw = paged_case(16, 40, 8, 128, 2080, 8, bf16, seed=1, pos=qpos)
    q, kp, vp, table, pos = args
    want = plain(*args, **kw)
    acc, m, l = paged_ops.paged_decode_partials(
        *args, n_split=n_split, split_len=split_len, **kw)
    last, slots = pos.long() // split_len, torch.arange(16, device="cuda")
    m[last, slots] = -torch.inf
    l[last, slots] = 0
    planted_rows("paged_decode", "qwen shapes", {
        "last tile of each slot left out":
        (kern(q, kp, vp, table, pos - 64, **kw), ROW_TOL),
        "last split of each row dropped from the combine":
        (paged_ops.paged_decode_combine(acc, m, l, bf16), ROW_TOL)},
        want, TOL["bfloat16"])
    del acc, m, l

    # times at the qwen decode shapes, bf16
    args, kw = paged_case(16, 40, 8, 128, 2080, 8, bf16, seed=1, pos=qpos)
    q, kp, vp, table, pos = args
    k_ms = time_ms(lambda: kern(*args, **kw))
    p_ms = time_ms(lambda: plain(*args, **kw), iters=5)
    # library yardstick: SDPA (GQA) over K/V gathered dense beforehand —
    # the gather is not timed; the port never calls SDPA
    kd = kp[table.long()].reshape(16, -1, 8, 128).transpose(1, 2)
    vd = vp[table.long()].reshape(16, -1, 8, 128).transpose(1, 2)
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qh = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    l_ms = time_ms(lambda: sdpa(qh, kd, vd, attn_mask=mask, enable_gqa=True))
    k_dev = device_ms(lambda: kern(*args, **kw), per_call=2)  # + combine
    l_dev = device_ms(lambda: sdpa(qh, kd, vd, attn_mask=mask,
                                   enable_gqa=True))
    live = int((pos.long() + 1).sum().item())
    nbytes = (live * 8 * 128 * 2 * 2 + 2 * q.numel() * 2
              + table.numel() * 4 + pos.numel() * 4)
    flops = live * 40 * 128 * 2 * 2
    bound = max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BPS >= flops / BF16_FLOPS \
        else "operations"
    log(f"paged_decode qwen bf16 (B 16, H 40/8, Dh 128, ps 8, "
        f"live positions {live}): max_err {errs[bf16]:.3e} kernel_ms "
        f"{k_ms:.4f} plain_ms {p_ms:.4f} library_ms {l_ms:.4f} bound_ms "
        f"{bound:.4f} ({bound_by}: {nbytes} B); device time alone "
        f"(profiler): kernel {ms_text(k_dev)} library {ms_text(l_dev)}")
    return {"name": "paged_decode_attention", "route": "cuda",
            "device_ms": k_dev, "library_device_ms": l_dev,
            "source": "src/repro_torch/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:121",
            "max_abs_err": errs[bf16], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": l_ms}


# ------------------------------------------------------------------ rmsnorm
def check_rms_norm():
    import numpy as np
    import torch

    from repro_torch.kernels.rmsnorm import rms_norm as kern
    from repro_torch.kernels.rmsnorm import rms_norm_ref as plain

    rng = np.random.default_rng(6)
    out = {}
    # qwen2.5-14b's width; minicpm3-4b's (2560, q_ln 768, kv_ln 256) and
    # mamba2-780m's (1536, gated 3072); the reference grid
    shapes = [(16, 1, 5120), (16 * 2048, 5120), (16, 1, 2560),
              (2048, 768), (16, 1, 256), (2048, 1536), (16, 1, 3072),
              (128, 256), (4, 32, 512), (1, 64)]
    for dt in (torch.float32, torch.bfloat16):
        for shape in shapes:
            x = torch.tensor(rng.standard_normal(shape, np.float32),
                             device="cuda").to(dt)
            w = torch.tensor(rng.standard_normal(shape[-1], np.float32)
                             * 0.1 + 1.0, device="cuda")
            for wt in (w, w.to(dt)):
                err = close(kern(x, w=wt), plain(x, wt), dt,
                            f"rms_norm {shape} {dt} w {wt.dtype}")
            out[(shape, dt)] = (x, w.to(dt), err)
    log(f"rms_norm: {2 * len(shapes) * 2} cases match the plain version "
        "(f32 rtol/atol 2e-5, bf16 2e-2)")
    lib = torch.nn.functional.rms_norm
    rows = []
    for shape in [(16 * 2048, 5120), (16, 1, 5120)]:
        x, w, err = out[(shape, torch.bfloat16)]
        k_ms = time_ms(lambda: kern(x, w))
        p_ms = time_ms(lambda: plain(x, w))
        l_ms = time_ms(lambda: lib(x, (shape[-1],), w, 1e-5))
        nbytes = 2 * x.numel() * 2 + w.numel() * 2
        flops = 4 * x.numel()
        bound = max(nbytes / HBM_BPS, flops / F32_FLOPS) * 1e3
        bound_by = "bytes" if nbytes / HBM_BPS >= flops / F32_FLOPS \
            else "operations"
        log(f"rms_norm {shape} bf16: max_err {err:.3e} kernel_ms "
            f"{k_ms:.4f} plain_ms {p_ms:.4f} library_ms {l_ms:.4f} "
            f"bound_ms {bound:.4f} ({bound_by}: {nbytes} B)")
        rows.append({"name": "rms_norm", "route": "triton",
                     "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
                     "replaces": "src/repro/kernels/rmsnorm/kernel.py:27",
                     "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": bound, "bound_by": bound_by,
                     "library_ms": l_ms})
    return rows[0]          # the prefill shape carries the bytes


# ---------------------------------------------------------------- paged MLA
def mla_case(b, h, rkv, dr, cache_len, ps, dtype, seed, pos=None,
             garbage_rest=True):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if pos is None:
        pos = rng.integers(0, cache_len, b)
        pos[0] = cache_len - 1
    pos = np.asarray(pos, np.int32)
    table, num_pages = paged_table(b, cache_len, ps, pos, rng, garbage_rest)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape, np.float32),
                            device="cuda").to(dtype)
    return (t((b, 1, h, rkv)), t((b, 1, h, dr)), t((num_pages, ps, rkv)),
            t((num_pages, ps, dr)), torch.tensor(table, device="cuda"),
            torch.tensor(pos, device="cuda"))


def check_paged_mla():
    import torch

    from repro_torch.kernels import (paged_mla_decode_attention as kern,
                                     paged_mla_decode_attention_ref as plain)
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention import ref as paged_ref

    f32, bf16 = torch.float32, torch.bfloat16
    n = 0
    rows_err = {}

    def held(got, want, dt, what):
        return held_rows(got, want, dt, what, rows_err)

    # the reference's grid (tests/test_kernels.py:140-163) in both dtypes,
    # at its scale (rkv + dr)^-1/2; 40 heads (not a power of two)
    for dt in (f32, bf16):
        for shape in [(2, 4, 32, 16, 16, 4), (3, 2, 16, 8, 12, 1),
                      (1, 8, 64, 32, 8, 8), (3, 40, 256, 32, 40, 8),
                      (2, 6, 128, 64, 24, 2)]:
            args = mla_case(*shape, dt, seed=9)
            kw = dict(page_size=shape[-1],
                      scale=(shape[2] + shape[3]) ** -0.5)
            held(kern(*args, **kw), plain(*args, **kw), dt,
                 f"mla grid {shape} {dt}")
            n += 1
    # poisoned garbage page must be inert, bit for bit (one split and
    # split shapes); future pages masked
    for dt in (f32, bf16):
        for shape, pos in (((3, 4, 32, 16, 16, 4), [0, 5, 15]),
                           ((4, 40, 256, 32, 2080, 8), [0, 255, 1000, 2079])):
            args = mla_case(*shape, dt, seed=10, pos=pos)
            kw = dict(page_size=shape[-1], scale=0.2)
            clean = kern(*args, **kw)
            args[2][0] = 1e4
            args[3][0] = 1e4
            poisoned = kern(*args, **kw)
            if not torch.equal(clean, poisoned) or \
                    not torch.isfinite(poisoned).all():
                raise AssertionError(f"garbage page leaked into the MLA "
                                     f"output ({dt}, {shape})")
            n += 1
        args = mla_case(2, 2, 16, 8, 16, 4, dt, seed=11, pos=[2, 9],
                        garbage_rest=False)
        kw = dict(page_size=4, scale=0.2)
        held(kern(*args, **kw), plain(*args, **kw), dt,
             f"mla future pages {dt}")
        n += 1
    # minicpm3-4b decode widths: 40 heads, Rkv 256, Dr 32, ps 8,
    # cache_len 2080, the model's scale (nope + rope)^-1/2
    kw = dict(page_size=8, scale=(64 + 32) ** -0.5)
    n_split, split_len = paged_ops.split_plan(2080, 8)
    # split boundaries: positions at and around the split length, a slot
    # at 0, the last position
    edge = [split_len - 2, split_len - 1, split_len, 0, 2079,
            2 * split_len - 1, 2 * split_len, 1]
    for dt in (f32, bf16):
        args = mla_case(8, 40, 256, 32, 2080, 8, dt, seed=12, pos=edge)
        held(kern(*args, **kw), plain(*args, **kw), dt,
             f"mla split edges (n_split {n_split}, split_len {split_len}) "
             f"{dt}")
        n += 1
    qpos = decode_pos()
    errs = {}
    for dt in (f32, bf16):
        args = mla_case(16, 40, 256, 32, 2080, 8, dt, seed=1, pos=qpos)
        errs[dt] = held(kern(*args, **kw), plain(*args, **kw), dt,
                        f"minicpm3 shapes {dt}")
        n += 1
    # the shared combine kernel against its plain version on the bf16
    # split kernel's own partials (these launches are not counted)
    args = mla_case(16, 40, 256, 32, 2080, 8, bf16, seed=1, pos=qpos)
    want = plain(*args, **kw)
    acc, m, l = paged_ops.paged_mla_decode_partials(
        *args, n_split=n_split, split_len=split_len, **kw)
    if not torch.equal(l == 0, m == -torch.inf):
        raise AssertionError("an empty MLA split's partial is not (m = "
                             "-inf, l = 0)")
    comb_err = held(paged_ops.paged_decode_combine(acc, m, l, bf16),
                    paged_ref.paged_decode_combine_ref(acc, m, l, bf16),
                    bf16, f"mla combine {bf16}")
    n += 1
    worst = max(rows_err, key=lambda k: rows_err[k][1])
    log(f"paged_mla_decode: {n} cases match the plain version (f32 "
        f"rtol/atol 2e-5, bf16 2e-2 and row error {ROW_TOL}); minicpm3 "
        f"shapes max|err| f32 {errs[f32]:.3e} bf16 {errs[bf16]:.3e}; bf16 "
        f"row error RMS / worst: minicpm3 shapes "
        f"{rows_err[f'minicpm3 shapes {bf16}'][0]:.3e} / "
        f"{rows_err[f'minicpm3 shapes {bf16}'][1]:.3e}, combine on the "
        f"split kernel's partials ({n_split} splits of {split_len}) max|err| "
        f"{comb_err:.3e}; worst row of all bf16 cases "
        f"{rows_err[worst][1]:.3e} ({worst})")

    # planted kernel faults at minicpm3's decode shape in bf16: the last
    # 64-position tile of every slot left out, and each row's last
    # non-empty split dropped from the combine (on the split kernel's
    # own partials); the row check must reject both
    ql, qr, cp, kp, table, pos = args
    last, slots = pos.long() // split_len, torch.arange(16, device="cuda")
    m[last, slots] = -torch.inf
    l[last, slots] = 0
    planted_rows("paged_mla_decode", "minicpm3 shapes", {
        "last tile of each slot left out":
        (kern(ql, qr, cp, kp, table, pos - 64, **kw), ROW_TOL),
        "last split of each row dropped from the combine":
        (paged_ops.paged_decode_combine(acc, m, l, bf16), ROW_TOL)},
        want, TOL["bfloat16"])
    del acc, m, l

    k_ms = time_ms(lambda: kern(*args, **kw))
    p_ms = time_ms(lambda: plain(*args, **kw), iters=5)
    # library yardstick: SDPA over [ckv || krope] keys (E 288) and ckv
    # values (Ev 256) gathered dense beforehand, one kv head broadcast to
    # the 40 query heads (the gather is not timed; the port never calls
    # SDPA)
    cd = cp[table.long()].reshape(16, 1, -1, 256)
    kd = torch.cat([cd, kp[table.long()].reshape(16, 1, -1, 32)], dim=-1)
    qh = torch.cat([ql, qr], dim=-1).transpose(1, 2)       # (16, 40, 1, 288)
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(qh, kd, cd, attn_mask=mask, scale=kw["scale"],
                    enable_gqa=True)
    l_ms = time_ms(library)
    k_dev = device_ms(lambda: kern(*args, **kw), per_call=2)  # + combine
    l_dev = device_ms(library)
    live = int((pos.long() + 1).sum().item())
    nbytes = (live * (256 + 32) * 2 + (ql.numel() + qr.numel()) * 2
              + ql.numel() * 2 + table.numel() * 4 + pos.numel() * 4)
    flops = live * 40 * (256 + 32 + 256) * 2
    bound = max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BPS >= flops / BF16_FLOPS \
        else "operations"
    log(f"paged_mla_decode minicpm3 bf16 (B 16, H 40, Rkv 256, Dr 32, ps 8, "
        f"live positions {live}, {n_split} splits of {split_len}): max_err "
        f"{errs[bf16]:.3e} kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
        f"library_ms {l_ms:.4f} bound_ms {bound:.4f} ({bound_by}: {nbytes} "
        f"B, {flops} FLOP); device time alone (profiler): kernel "
        f"{ms_text(k_dev)} library {ms_text(l_dev)}")
    return {"name": "paged_mla_decode_attention", "route": "cuda",
            "device_ms": k_dev, "library_device_ms": l_dev,
            "source": "src/repro_torch/csrc/paged_mla_decode.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:200",
            "max_abs_err": errs[bf16], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": l_ms}


# ----------------------------------------------------------------- SSD scan
def ssd_case(b, s, h, p, n, dtype, seed):
    """tests/test_kernels.py:211-216, drawn with numpy on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0, dt=dtype):
        return (torch.tensor(rng.standard_normal(shape, np.float32),
                             device="cuda") * scale).to(dt)
    x = t((b, s, h, p))
    dt = torch.nn.functional.softplus(t((b, s, h), dt=torch.float32)) * 0.1
    a = -torch.exp(t((h,), 0.3, torch.float32))
    return x, dt, a, t((b, s, h, n), 0.5), t((b, s, h, n), 0.5)


def ssd_model_layout(b, s, h, p, n, dtype, seed):
    """x, dt, a, B and C as ``models/ssm.py`` hands them to the scan at
    mamba2-780m's ``ssm_ngroups = 1``: x a view of the conv output (B, S,
    H*P + 2N), B and C its one group expanded to every head (head stride
    0), read in place."""
    import torch

    x, dt, a, bmat, cmat = ssd_case(b, s, h, p, n, dtype, seed)
    conv = torch.cat([x.flatten(2), bmat[:, :, 0], cmat[:, :, 0]], -1)
    bc = conv[..., h * p:].unflatten(-1, (2, 1, n))
    return (conv[..., :h * p].unflatten(-1, (h, p)), dt, a,
            bc[:, :, 0].expand(b, s, h, n), bc[:, :, 1].expand(b, s, h, n))


def check_ssd():
    import torch

    from repro_torch.kernels import ssd_scan as kern
    from repro_torch.kernels import ssd_scan_ref as plain
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops

    f32, bf16 = torch.float32, torch.bfloat16
    n = 0
    rows_err = {}

    def plain_f32(args, chunk):
        """The plain version in f32 from the same (bf16) inputs."""
        x, dt, a, bmat, cmat = args
        return plain(x.float(), dt, a, bmat.float(), cmat.float(),
                     chunk=chunk)

    def both(args, chunk, dt, what, plain_chunk=None):
        y, hf = kern(*args, chunk=chunk)
        y_r, hf_r = plain(*args, chunk=plain_chunk or chunk)
        err = max(close(y, y_r, dt, f"{what} y", SSD_TOL),
                  close(hf, hf_r, dt, f"{what} h_final", SSD_TOL))
        if dt == bf16:      # y row by row against the f32 plain version
            rows_err[what] = rows_close(
                y, plain_f32(args, plain_chunk or chunk)[0], f"{what} y",
                SSD_ROW_TOL)
        return err

    # the reference's grid (tests/test_kernels.py:205-243) in both dtypes
    for dt in (f32, bf16):
        for b, s, h, p, nn, chunk in [(1, 128, 2, 64, 32, 32),
                                      (2, 256, 4, 32, 64, 64),
                                      (1, 64, 1, 16, 16, 64)]:
            both(ssd_case(b, s, h, p, nn, dt, seed=4), chunk, dt,
                 f"ssd grid {(b, s, h, p, nn, chunk)} {dt}")
            n += 1
    # chunk invariance, and a short last chunk (S not a multiple of the
    # chunk) against the plain version over one chunk of all S positions
    for dt in (f32, bf16):
        args = ssd_case(1, 128, 2, 32, 32, dt, seed=5)
        ys = [kern(*args, chunk=c)[0] for c in (16, 32, 128)]
        for y in ys[1:]:
            close(y, ys[0], dt, f"ssd chunk invariance {dt}", SSD_TOL)
        for s, chunk in ((100, 32), (300, 256), (2047, 256)):
            both(ssd_case(2, s, 3, 64, 128, dt, seed=6), chunk, dt,
                 f"ssd partial last chunk S {s} {dt}", plain_chunk=s)
        n += 4
    # mamba2-780m prefill shapes: 48 heads, P 64, N 128, chunk 256, S 2048,
    # per-head B and C, then B and C in the model's own layout (one group
    # broadcast to every head, read in place): the same numbers bit for bit
    errs = {}
    for b in (1, 16):
        for dt in (f32, bf16):
            args = ssd_model_layout(b, 2048, 48, 64, 128, dt, seed=1)
            per_head = [t.contiguous() for t in args]
            what = f"mamba2 shapes B {b} {dt}"
            errs[(b, dt)] = both(per_head, 256, dt, what)
            y, hf = kern(*args, chunk=256)
            y2, hf2 = kern(*per_head, chunk=256)
            if not (torch.equal(y, y2) and torch.equal(hf, hf2)):
                raise AssertionError(f"{what}: B and C read in place (head "
                                     "stride 0) differ from per-head copies")
            n += 2
    worst = max(rows_err, key=lambda k: rows_err[k][1])
    log(f"ssd_scan: {n} cases match the plain version (f32 rtol/atol 1e-4, "
        f"bf16 4e-2, and bf16 y row by row against the plain version in f32 "
        f"{SSD_ROW_TOL}); mamba2 shapes max|err| "
        + ", ".join(f"B {b} {str(dt)[6:]} {e:.3e}"
                    for (b, dt), e in errs.items())
        + f"; bf16 row error RMS / worst at B 1: "
        f"{rows_err[f'mamba2 shapes B 1 {bf16}'][0]:.3e} / "
        f"{rows_err[f'mamba2 shapes B 1 {bf16}'][1]:.3e}; worst row of all "
        f"bf16 cases {rows_err[worst][1]:.3e} ({worst})")

    # the bf16 phases one by one, and a planted fault between them: the
    # state entering chunk 4 of 8 not handed on (zeroed).  The row check
    # must reject it.
    args = ssd_model_layout(1, 2048, 48, 64, 128, bf16, seed=1)
    want = plain_f32(args, 256)[0]
    states, decay = ssd_ops.ssd_chunk_states(*args, chunk=256)
    h_prev, _ = ssd_ops.ssd_state_pass(states, decay)
    rows_close(ssd_ops.ssd_chunk_output(*args, h_prev, chunk=256), want,
               "ssd phases one by one", SSD_ROW_TOL)
    h_prev[:, :, 4] = 0
    planted_rows("ssd_scan", "mamba2 shapes B 1", {
        "state entering chunk 4 not handed on":
        (ssd_ops.ssd_chunk_output(*args, h_prev, chunk=256), SSD_ROW_TOL)},
        want, SSD_TOL["bfloat16"])
    del states, decay, h_prev

    rows = []
    for b in (1, 16):
        args = ssd_model_layout(b, 2048, 48, 64, 128, bf16, seed=1)
        k_ms = time_ms(lambda: kern(*args, chunk=256))
        k_dev = device_ms(lambda: kern(*args, chunk=256), per_call=3)
        p_ms = time_ms(lambda: plain(*args, chunk=256), iters=2, warmup=1)
        h, s, p, nn, q = 48, 2048, 64, 128, 256
        # x, dt and a read once, y and h_final written once; B and C once
        # per group (ngroups 1): the kernel reads the model's broadcast
        # view in place, so the 48 heads share one copy in device memory.
        # The count of the first version, B and C once per head (what its
        # wrapper's copies wrote out), is logged beside it.
        rest = (b * s * h * p * 2 + b * s * h * 4 + h * 4
                + b * s * h * p * 2 + b * h * p * nn * 4)
        nbytes = rest + b * s * 2 * nn * 2
        nbytes_head = rest + b * s * h * 2 * nn * 2
        per_chunk = q * (q + 1) // 2 * (nn + p) + 2 * q * p * nn
        flops = 2 * b * h * (s // q) * per_chunk
        bound = max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3
        bound_head = max(nbytes_head / HBM_BPS, flops / BF16_FLOPS) * 1e3
        bound_by = "bytes" if nbytes / HBM_BPS >= flops / BF16_FLOPS \
            else "operations"
        log(f"ssd_scan mamba2 bf16 (B {b}, S 2048, H 48, P 64, N 128, "
            f"chunk 256, B and C in the model's layout): max_err "
            f"{errs[(b, bf16)]:.3e} kernel_ms {k_ms:.4f} plain_ms "
            f"{p_ms:.4f} library_ms none (no single PyTorch call computes "
            f"it) bound_ms {bound:.4f} ({bound_by}: {nbytes} B with B and "
            f"C once per group, {flops} FLOP) [B and C once per head: "
            f"{bound_head:.4f} ms, {nbytes_head} B]; device time alone "
            f"(profiler, three launches) {ms_text(k_dev)}")
        rows.append({"name": "ssd_scan", "route": "cuda",
                     "device_ms": k_dev,
                     "source": "src/repro_torch/csrc/ssd_chunk.cu",
                     "replaces": "src/repro/kernels/ssd_chunk/kernel.py:80",
                     "max_abs_err": errs[(b, bf16)], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": None})
    return rows[0]          # batch 1: the serve phase's prefill shape


# ---------------------------------------------------------- flash attention
def row_rel(got, want):
    """Per output row (the last axis): ||got - want|| / ||want||, rows with
    ``want`` all zero left out.  Returns (RMS over rows, worst row)."""
    g, w = got.float(), want.float()
    n2 = w.square().sum(-1)
    live = n2 > 0
    r = (g - w).square().sum(-1)[live] / n2[live]
    return r.mean().sqrt().item(), r.max().sqrt().item()


def rows_close(got, want, what, tol=ROW_TOL):
    rms, worst = row_rel(got, want)
    if rms > tol["rms"] or worst > tol["worst"]:
        raise AssertionError(
            f"{what}: kernel vs plain row error RMS {rms:.3e} / worst "
            f"{worst:.3e} outside {tol}")
    return rms, worst


def flash_case(b, sq, sk, h, hkv, d, dtype, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape, np.float32),
                            device="cuda").to(dtype)
    return t((b, sq, h, d)), t((b, sk, hkv, d)), t((b, sk, hkv, d))


def flash_pairs(sq, sk, causal, window):
    """(query, key) pairs the mask leaves: the work of one head."""
    import numpy as np

    i = np.arange(sq)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(sq, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def check_flash():
    import torch

    from repro_torch.kernels import flash_attention as kern
    from repro_torch.kernels import flash_attention_ref as plain

    f32, bf16 = torch.float32, torch.bfloat16
    n = 0
    rows_err = {}

    def both(shape, dt, what, seed=0, **kw):
        args = flash_case(*shape, dt, seed)
        got, want = kern(*args, **kw), plain(*args, **kw)
        err = close(got, want, dt, what)
        if dt == bf16:
            rows_err[what] = rows_close(got, want, what)
        return err, args

    # the reference's grid (tests/test_kernels.py:26-77) in both dtypes,
    # lengths no multiple of a tile, the registry's group sizes, windows,
    # non-causal
    for dt in (f32, bf16):
        for shape in [(1, 128, 128, 2, 2, 64), (2, 256, 256, 4, 1, 64),
                      (1, 128, 256, 8, 2, 128), (1, 64, 64, 2, 2, 32),
                      (2, 100, 100, 4, 2, 64), (1, 300, 300, 6, 1, 128)]:
            both(shape, dt, f"flash grid {shape} {dt}")
            n += 1
        for g in (1, 2, 4, 5, 6, 8, 12):
            both((2, 130, 130, 2 * g, 2, 64), dt, f"flash group {g} {dt}",
                 seed=g, window=40)
            n += 1
        for w in (1, 16, 100):
            both((2, 300, 300, 8, 2, 128), dt, f"flash window {w} {dt}",
                 window=w)
            n += 1
        for w in (None, 30):
            both((2, 64, 128, 4, 2, 64), dt, f"flash non-causal w {w} {dt}",
                 causal=False, window=w)
            n += 1
        # Sq > Sk + window - 1: rows past Sk + window - 2 see no key
        _, args = both((1, 200, 40, 4, 2, 32), dt, f"flash dead rows {dt}",
                       window=16)
        dead = kern(*args, window=16)[:, 40 + 16 - 1:]
        if not torch.equal(dead, torch.zeros_like(dead)):
            raise AssertionError("flash: rows with no valid key are not 0")
        n += 1
    # the serve paths' prefill shapes: qwen2.5-14b (1 x 2048 and 16 x 512,
    # causal, 40 / 8 heads) and mixtral-8x7b (1 x 8192, window 4096, 32 / 8)
    serve = {"qwen 1x2048": ((1, 2048, 2048, 40, 8, 128), None),
             "qwen 16x512": ((16, 512, 512, 40, 8, 128), None),
             "mixtral 1x8192": ((1, 8192, 8192, 32, 8, 128), 4096)}
    errs = {}
    for name, (shape, w) in serve.items():
        for dt in (f32, bf16):
            errs[(name, dt)], _ = both(shape, dt, f"flash {name} {dt}",
                                       window=w)
            n += 1
            torch.cuda.empty_cache()
    worst = max(rows_err, key=lambda k: rows_err[k][0])
    log(f"flash_attention: {n} cases match the plain version (f32 "
        f"rtol/atol 2e-5, bf16 2e-2 and row error {ROW_TOL}); serve "
        "shapes max|err| " + ", ".join(f"{k} {str(dt)[6:]} {e:.3e}"
                                       for (k, dt), e in errs.items())
        + "; bf16 row error RMS / worst: " + ", ".join(
            f"{k} {rows_err[f'flash {k} {bf16}'][0]:.3e} / "
            f"{rows_err[f'flash {k} {bf16}'][1]:.3e}" for k in serve)
        + f"; largest RMS of all bf16 cases {rows_err[worst][0]:.3e} "
        f"({worst})")

    # planted kernel fault: mixtral's window one 64-key tile short, as a
    # kernel whose window bound is off by a tile would compute it.  The
    # row check must reject it; what the elementwise bf16 tolerance says
    # of it is logged.
    q, k, v = flash_case(1, 8192, 8192, 32, 8, 128, bf16, 0)
    got, want = kern(q, k, v, window=4096 - 64), plain(q, k, v, window=4096)
    rms, worst = row_rel(got, want)
    elementwise = torch.allclose(got.float(), want.float(), **TOL["bfloat16"])
    log(f"flash planted fault (window one tile short, mixtral 1x8192): row "
        f"error RMS {rms:.3e} / worst {worst:.3e}; elementwise bf16 "
        f"tolerance alone {'passes' if elementwise else 'rejects'} it")
    if rms <= ROW_TOL["rms"] and worst <= ROW_TOL["worst"]:
        raise AssertionError("flash: the row check does not reject the "
                             "planted fault (window one tile short)")
    del q, k, v, got, want
    torch.cuda.empty_cache()

    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, (shape, w) in serve.items():
        b, sq, sk, h, hkv, d = shape
        q, k, v = flash_case(*shape, bf16, seed=0)
        k_ms = time_ms(lambda: kern(q, k, v, window=w))
        p_ms = time_ms(lambda: plain(q, k, v, window=w), iters=2, warmup=1,
                       reps=3)
        torch.cuda.empty_cache()
        # library yardstick: SDPA on (B, H, S, D) views, GQA expanded by
        # the call; the window as an explicit boolean mask (the port never
        # calls SDPA)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if w is None:
            l_ms = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True,
                                        enable_gqa=True))

        else:
            i = torch.arange(sq, device="cuda")[:, None]
            j = torch.arange(sk, device="cuda")[None, :]
            mask = (j <= i) & (j > i - w)
            l_ms = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask,
                                        enable_gqa=True))
            del mask
        pairs = flash_pairs(sq, sk, True, w)
        flops = 4 * b * h * pairs * d
        nbytes = 2 * (2 * b * sq * h * d + 2 * b * sk * hkv * d)
        bound = max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3
        bound_by = "bytes" if nbytes / HBM_BPS >= flops / BF16_FLOPS \
            else "operations"
        log(f"flash_attention {name} bf16 (H {h}/{hkv}, D {d}, window {w}): "
            f"max_err {errs[(name, bf16)]:.3e} kernel_ms {k_ms:.4f} "
            f"plain_ms {p_ms:.4f} library_ms {l_ms:.4f} bound_ms "
            f"{bound:.4f} ({bound_by}: {flops} FLOP over {pairs} pairs per "
            f"head, {nbytes} B; f32 CUDA-core floor "
            f"{flops / F32_FLOPS * 1e3:.4f} ms); {flops / k_ms / 1e9:.1f} "
            "TFLOP/s")
        rows.append({"name": "flash_attention", "shape": name,
                     "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces":
                         "src/repro/kernels/flash_attention/kernel.py:106",
                     "max_abs_err": errs[(name, bf16)], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": l_ms})
        del q, k, v
        torch.cuda.empty_cache()
    return rows             # one row per serve shape


# ------------------------------------------------------------- main path
def arch_of(cfg):
    """The phase's arch name (a ``tiny()`` config for a CPU rehearsal
    carries a suffix)."""
    return cfg.name.removesuffix("-tiny")


def steps_alone(cfg, params, smi, paged_kernel, traffic, ps=8):
    """Where a tick's time goes: one decode tick of the phase's shapes
    (``traffic``'s slots, cache_len and prompt lengths) and one prefill of
    its longest prompt, run alone (no engine, no other thread), host-timed
    around a synchronize, and the decode tick once more under
    torch.profiler for the device's busy time by kernel."""
    import numpy as np
    import torch

    from repro_torch.steps import (init_paged_slot_cache, make_decode_step,
                                   make_prefill_step)

    slots, cache_len = traffic["slots"], traffic["cache_len"]
    rng = np.random.default_rng(5)
    pps = cache_len // ps
    num_pages = 1 + slots * pps
    cache = init_paged_slot_cache(cfg, slots, cache_len, torch.bfloat16, ps,
                                  num_pages, "cuda")
    pos = rng.choice(traffic["lens"], slots) + rng.integers(0, 31, slots)
    pos_dev = torch.tensor(pos.astype(np.int32), device="cuda")
    cache["pos"] = pos_dev.clone()
    table = torch.tensor(rng.permutation(np.arange(1, num_pages))
                         .reshape(slots, pps).astype(np.int32),
                         device="cuda")
    toks = torch.tensor(rng.integers(0, cfg.vocab, (slots, 1))
                        .astype(np.int32), device="cuda")
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    decode = make_decode_step(cfg, cache_len=cache_len, page_size=ps,
                              paged_kernel=paged_kernel)

    def tick():
        nonlocal cache
        _, cache = decode(params, cache, toks, active, table)
        cache["pos"] = pos_dev.clone()      # a device copy: no host sync

    def host_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    tick_ms = host_ms(tick, 5)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        tick()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)          # one stream: kernels serialise
    del cache
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    plen = max(traffic["lens"])
    ptoks = torch.tensor(rng.integers(0, cfg.vocab, (1, plen))
                         .astype(np.int32), device="cuda")
    pre_ms = host_ms(lambda: prefill(params, ptoks), 2)
    log(f"steps alone ({cfg.name}, {smi}): decode tick ({slots} slots"
        f"{', paged kernel' if paged_kernel else ''}) {tick_ms:.2f} ms "
        f"host; device busy {busy:.2f} ms in one profiled tick (idle "
        f"{max(0.0, 1 - busy / tick_ms) * 100:.0f} %); prefill (1 x {plen}) "
        f"{pre_ms:.2f} ms host")
    for key, ms, n in rows[:8]:
        log(f"  tick kernel {ms:8.3f} ms x{n:5d}  {key[:90]}")


def plain_ssd(x, dt, a, bmat, cmat, *, chunk):
    """The reference model's own SSD math (``ssd_chunked``, state carried
    in the activation dtype from a zero state) in place of the kernel, at
    any length: a length that does not split into equal chunks is one
    chunk (the math does not depend on the chunk length)."""
    import torch

    from repro_torch.models.ssm import ssd_chunked

    b, s, h, p = x.shape
    nc = max(1, s // chunk)
    init = torch.zeros((b, h, p, bmat.shape[-1]), dtype=x.dtype,
                       device=x.device)
    return ssd_chunked(x, dt, a, bmat, cmat,
                       chunk if nc * (s // nc) == s else s, init)


@contextlib.contextmanager
def swapped(*swaps):
    """Module attributes swapped for the block: (module, name, value)."""
    saved = [(m, k, getattr(m, k)) for m, k, _ in swaps]
    for m, k, v in swaps:
        setattr(m, k, v)
    try:
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def planted(fault):
    """The path with one fault of ``PLANTED`` swapped into its module
    (``None``: as it is)."""
    import torch

    from repro_torch.models import attention as att
    from repro_torch.models import blocks, moe, ssm

    rope, kern, mla = (att.apply_rope, att.paged_decode_attention,
                       att.paged_mla_decode_attention)
    scan, ssm_apply = ssm.ssd_scan, blocks.ssm_apply
    flash, route = att.flash_attention, moe.route

    def rope_pos_plus_1(x, pos, theta=10_000.0):
        return rope(x, pos + 1, theta)

    def kv_group_order(q, kp, vp, table, pos, **kw):
        # flat head h reads kv head h % Hkv instead of h // group
        b, _, h, dh = q.shape
        g = h // kp.shape[2]
        qs = q.view(b, 1, g, h // g, dh).transpose(2, 3).reshape(q.shape)
        o = kern(qs.contiguous(), kp, vp, table, pos, **kw)
        return o.view(b, 1, h // g, g, dh).transpose(2, 3).reshape(q.shape)

    def pos_fault(fn, shift):
        def wrapped(*args, **kw):
            *front, pos = args
            return fn(*front, shift(pos), **kw)
        return wrapped

    def q_rope_next_head(q_lat, q_rope, *args, **kw):
        # head h scores with the rope query of head h + 1
        return mla(q_lat, q_rope.roll(-1, dims=2).contiguous(), *args, **kw)

    def state_not_handed(*args, **kw):
        y, hf = scan(*args, **kw)
        return y, torch.zeros_like(hf)

    def dt_one_late(x, dt, *args, **kw):
        return scan(x, torch.cat([dt[:, :1], dt[:, :-1]], 1), *args, **kw)

    def conv_tail_rolled(x, p, cfg, spec, *, mode, cache=None, **kw):
        if mode == "decode":
            cache["conv"].copy_(cache["conv"].roll(1, dims=1))
        return ssm_apply(x, p, cfg, spec, mode=mode, cache=cache, **kw)

    def flash_kv_group_order(q, k, v, **kw):
        # flat head h reads kv head h % Hkv instead of h // group
        b, s, h, d = q.shape
        g = h // k.shape[2]
        qs = q.view(b, s, g, h // g, d).transpose(2, 3).reshape(q.shape)
        o = flash(qs.contiguous(), k, v, **kw)
        return o.view(b, s, h // g, g, d).transpose(2, 3).reshape(q.shape)

    def moe_second_pick_dropped(*args, **kw):
        topv, topi, lb = route(*args, **kw)
        return topv * torch.tensor([1.0, 0.0], device=topv.device), topi, lb

    def moe_ids_permuted(xn, router, cfg, aux=True):
        # each pick goes to the next expert, with its own weight
        topv, topi, lb = route(xn, router, cfg, aux)
        return topv, (topi + 1) % cfg.n_experts, lb

    def ring_not_rolled(t, ring):
        # the reference's placement: the last ring positions unrolled
        return t[:, t.shape[1] - ring:]

    def roll(pos):
        return pos.roll(1)

    def older(pos):
        return pos - 1

    swaps = {
        None: (),
        "rope_pos_plus_1": ((att, "apply_rope", rope_pos_plus_1),),
        "kv_group_order": ((att, "paged_decode_attention", kv_group_order),),
        "slot_pos_rolled": ((att, "paged_decode_attention",
                             pos_fault(kern, roll)),
                            (att, "paged_mla_decode_attention",
                             pos_fault(mla, roll))),
        "newest_kv_left_out": ((att, "paged_decode_attention",
                                pos_fault(kern, older)),
                               (att, "paged_mla_decode_attention",
                                pos_fault(mla, older))),
        "q_rope_next_head": ((att, "paged_mla_decode_attention",
                              q_rope_next_head),),
        "state_not_handed": ((ssm, "ssd_scan", state_not_handed),),
        "dt_one_late": ((ssm, "ssd_scan", dt_one_late),),
        "conv_tail_rolled": ((blocks, "ssm_apply", conv_tail_rolled),),
        "flash_kv_group_order": ((att, "flash_attention",
                                  flash_kv_group_order),),
        "moe_second_pick_dropped": ((moe, "route", moe_second_pick_dropped),),
        "moe_ids_permuted": ((moe, "route", moe_ids_permuted),),
        "ring_not_rolled": ((att, "ring_from_prefill", ring_not_rolled),),
    }
    return swapped(*swaps[fault])


def path_check(cfg, params, prompts, toks, ref, device, paged_kernel,
               slots=16, cache_len=2080, ps=8, names=None):
    """The engine's step path teacher-forced with its emitted tokens: each
    prompt through the prefill step and the paged insert, then the tokens
    one tick at a time through the decode forward (paged kernel where the
    phase has one), ``slots`` requests per round — as built and under each
    planted fault (a fault of the prefill side gets its own prefill), or
    under ``names`` only.  Returns name -> {"rel": aggregate relative
    logit error against ``ref``, "rel_max": worst position, "effect": the
    same distance from the path as built, "gap": worst gap of the path's
    argmax under ``ref``, "same": path argmax equal to the emitted token}
    ({} when ``ref`` is None: the path only runs)."""
    import numpy as np
    import torch

    from repro_torch.models.lm import forward
    from repro_torch.steps import (cast_tree, init_paged_slot_cache,
                                   make_batched_insert_step,
                                   make_prefill_step)

    p = cast_tree(params, cfg.dtype)
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    insert = make_batched_insert_step(cfg, cache_len=cache_len, page_size=ps)
    pps = cache_len // ps
    cache = init_paged_slot_cache(cfg, slots, cache_len, getattr(
        torch, cfg.dtype), ps, 1 + slots * pps, device)
    table = (1 + torch.randperm(slots * pps, generator=torch.Generator()
                                .manual_seed(3))).int().view(slots, pps)
    table = table.to(device)
    pages = {"table": table, "page_size": ps, "cache_len": cache_len,
             "kernel": paged_kernel}
    if names is None:
        names = [None, *PLANTED[arch_of(cfg)]]
    acc = {n: {"d2": 0.0, "r2": 0.0, "e2": 0.0, "rel_max": 0.0, "gap": 0.0,
               "same": 0} for n in names}
    gen = len(toks[0])
    for r0 in range(0, len(prompts), slots):
        idx = list(range(r0, min(r0 + slots, len(prompts))))
        pad = slots - len(idx)
        pos0 = torch.tensor([len(prompts[i]) for i in idx] + [0] * pad,
                            dtype=torch.int32, device=device)
        feed = torch.tensor(np.stack([toks[i] for i in idx]
                                     + [np.zeros(gen, np.int32)] * pad),
                            device=device)

        def prefill_round():
            return [prefill(p, torch.tensor(prompts[i][None], device=device))
                    for i in idx]

        clean = prefill_round()
        for n in names:
            with planted(n):
                rounds = prefill_round() if n in PREFILL_FAULTS else clean
                for s, (rows, _) in enumerate(rounds):
                    cache = insert(cache, rows, 0, s, table[s])
                rows = [torch.stack([lg[0, -1].float() for _, lg in rounds])]
                del rounds
                for j in range(gen - 1):
                    o = forward(p, cfg, feed[:, j:j + 1], mode="decode",
                                pos=pos0 + j, cache=cache, pages=pages)
                    rows.append(o["logits"][:len(idx), 0].float())
            lg = torch.stack(rows, dim=1)               # (round, gen, V)
            if ref is None:
                continue
            if n is None:
                built = lg
            a = acc[n]
            for s, i in enumerate(idx):
                d = lg[s] - ref[i]
                c = ref[i] - ref[i].mean(dim=-1, keepdim=True)
                d2, r2 = d.square().sum(-1), c.square().sum(-1)
                a["d2"] += d2.sum().item()
                a["r2"] += r2.sum().item()
                a["e2"] += (lg[s] - built[s]).square().sum().item()
                a["rel_max"] = max(a["rel_max"],
                                   (d2 / r2).sqrt().max().item())
                am = lg[s].argmax(-1)
                gap = ref[i].max(-1).values - ref[i].gather(
                    1, am[:, None])[:, 0]
                a["gap"] = max(a["gap"], gap.max().item())
                a["same"] += int((am.cpu() == torch.as_tensor(
                    toks[i]).long()).sum())
        del clean
    if ref is None:
        return {}
    return {n: {"rel": (a["d2"] / a["r2"]) ** 0.5, "rel_max": a["rel_max"],
                "effect": (a["e2"] / a["r2"]) ** 0.5, "gap": a["gap"],
                "same": a["same"]} for n, a in acc.items()}


def moe_layers(cfg):
    return cfg.n_repeats * sum(spec.mlp == "moe" for spec in cfg.pattern)


@contextlib.contextmanager
def routes_recorded(store):
    """Every MoE routing in the block appends its (B, S, K) expert ids to
    ``store``."""
    from repro_torch.models import moe

    route = moe.route

    def recorded(*args, **kw):
        out = route(*args, **kw)
        store.append(out[1])
        return out
    with swapped((moe, "route", recorded)):
        yield


def path_routes(store, cfg, lens, slots, gen):
    """Per request, per MoE layer, the (S + gen - 1, K) expert ids that
    ``path_check`` (as built) gave each position, from the order it routes
    in: per round of ``slots`` requests, each request's prefill, then
    gen - 1 decode ticks over the round's slots."""
    import torch

    n = moe_layers(cfg)
    it = iter(store)
    out = []
    for r0 in range(0, len(lens), slots):
        idx = range(r0, min(r0 + slots, len(lens)))
        pre = [[next(it)[0] for _ in range(n)] for _ in idx]
        dec = [[next(it) for _ in range(n)] for _ in range(gen - 1)]
        for s in range(len(idx)):
            out.append([torch.cat([pre[s][layer]]
                                  + [dec[j][layer][s] for j in range(gen - 1)])
                        for layer in range(n)])
    return out


@contextlib.contextmanager
def routes_forced(layers, flips):
    """MoE layers route, in call order, to the expert ids ``layers`` gives
    (their weights still come from this forward's own router); ``flips``
    gets, per layer, which positions would have picked another top-k set
    on their own, and the margin between the forward's own k-th and
    (k+1)-th router probabilities there."""
    from repro_torch.models import moe

    it = iter(layers)

    def forced(xn, router, cfg, aux=True):
        probs = moe.router_probs(xn, router)
        topi = next(it)[None]
        own_v, own = probs.topk(cfg.top_k + 1, dim=-1)
        own = own[..., :cfg.top_k]
        flips.append(((own.sort(-1).values != topi.sort(-1).values)
                      .any(-1)[0],
                      (own_v[..., -2] - own_v[..., -1])[0]))
        topv = probs.gather(-1, topi)
        return topv / topv.sum(dim=-1, keepdim=True), topi, None
    with swapped((moe, "route", forced)):
        yield


def recorded_routes(cfg, params, plist, toks, device, phase, fault=None):
    """Per request, per MoE layer, the expert ids of one run of
    ``path_check`` over ``plist`` — the path as built, or with ``fault``
    planted in its routing."""
    store = []
    with planted(fault), routes_recorded(store):
        path_check(cfg, params, plist, toks, None, device,
                   phase["paged_kernel"], slots=phase["traffic"]["slots"],
                   cache_len=phase["traffic"]["cache_len"], names=[None])
    return path_routes(store, cfg, [len(x) for x in plist],
                       phase["traffic"]["slots"], len(toks[0]))


def route_check(flips, n_moe, starts):
    """Route check over the ``flips`` of ``routes_forced`` (one forward
    per request, in order; ``starts``: each request's first checked
    position).  Returns its figures; ``wide_flips`` counts the (layer,
    position) pairs whose margin is above the layer's bound
    (``ROUTE_MARGIN_FIRST`` in the first MoE layer, ``ROUTE_MARGIN`` after
    it) and whose path picked another top-k set."""
    import torch

    flip = torch.cat([f for f, _ in flips])
    margin = torch.cat([m for _, m in flips])
    checked = torch.cat([
        torch.arange(len(f), device=f.device) >= starts[k // n_moe]
        for k, (f, _) in enumerate(flips)])
    first = torch.cat([torch.full_like(f, k % n_moe == 0)
                       for k, (f, _) in enumerate(flips)])
    sure = margin > torch.where(first, ROUTE_MARGIN_FIRST, ROUTE_MARGIN)
    at_flips = margin[flip]
    return {
        "pairs": flip.numel(), "flips": flip.sum().item(),
        "flips_checked": (flip & checked).sum().item(),
        "sure": sure.sum().item(), "sure_first": (sure & first).sum().item(),
        "pairs_first": first.sum().item(),
        "widest_flip": at_flips.max().item() if at_flips.numel() else 0.0,
        "flip_margin_p99": torch.quantile(
            at_flips[:2 ** 24].float(), 0.99).item()
        if at_flips.numel() else 0.0,
        "wide_flips": (flip & sure).sum().item(),
        "widest_by_layer": [
            max((m[f].max().item() for f, m in flips[i::n_moe] if f.any()),
                default=0.0) for i in range(n_moe)]}


def route_line(what, f):
    return (f"{what}: the forward's own top-k differs from the path's at "
            f"{f['flips']} of {f['pairs']} (layer, position) pairs "
            f"({f['flips_checked']} at checked positions); margin at those "
            f"p99 {f['flip_margin_p99']:.4f} widest {f['widest_flip']:.4f}; "
            f"{f['sure']} pairs have a margin above the bound "
            f"({f['sure_first']} of the first MoE layer's {f['pairs_first']} "
            f"above {ROUTE_MARGIN_FIRST}, the rest above {ROUTE_MARGIN}), "
            f"{f['wide_flips']} of them differ; widest flip margin by layer "
            + " ".join(f"{m:.4f}" for m in f["widest_by_layer"]))


def check_capacity_dispatch(cfg, params, device, seed=0):
    """The registry's capacity dispatch (``moe_mlp``) on the card at the
    phase's layer shape and first MoE layer's weights, for 2 x 4096
    tokens: against the dropless dispatch with the weights of the picks
    that overflow zeroed, the overflow found by a numpy walk of the
    reference's rule (per batch row, token-major, pick-minor; a pick
    keeps the next slot of its expert's queue, dropped past
    ``capacity``).  At capacity factor 0.9 (below an even share) the
    rule must drop picks; the registry's factor is checked too.  Returns
    the drops at the registry's factor."""
    import numpy as np
    import torch

    from repro_torch.models import moe

    p = {k: v[0] for k, v in params["blocks"][0]["mlp"].items()}
    g = torch.Generator(device).manual_seed(seed)
    xn = torch.randn((2, 4096, cfg.d_model), generator=g, device=device,
                     dtype=getattr(torch, cfg.dtype))
    route = moe.route
    drops = {}
    for cf in (0.9, cfg.capacity_factor):
        c_cfg = cfg.replace(capacity_factor=cf)
        got, _ = moe.moe_mlp(xn, p, c_cfg, aux=False)
        topv, topi, _ = route(xn, p["router"], c_cfg, aux=False)
        c = moe.capacity(xn.shape[1], c_cfg)
        ids = topi.reshape(topi.shape[0], -1).cpu().numpy()
        keep = np.zeros(ids.shape, bool)
        for b in range(ids.shape[0]):
            for e in range(cfg.n_experts):
                at = np.flatnonzero(ids[b] == e)
                keep[b, at[:c]] = True
        drops[cf] = int((~keep).sum())
        mask = torch.as_tensor(keep, device=device).view(topv.shape)

        def masked(*args, **kw):
            v, i, lb = route(*args, **kw)
            return v * mask, i, lb
        with swapped((moe, "route", masked)):
            want, _ = moe.moe_mlp_ragged(xn, p, c_cfg, aux=False)
        rms, worst = row_rel(got, want)
        log(f"MoE capacity dispatch ({cfg.name}, 2 x 4096 tokens, d "
            f"{cfg.d_model}, d_ff {cfg.d_ff}, capacity factor {cf}: "
            f"{c} slots per expert): {drops[cf]} of {ids.size} picks "
            f"dropped; against dropless with those picks zeroed, row error "
            f"RMS {rms:.3e} / worst {worst:.3e} (bounds "
            f"{ROW_TOL})")
        if rms > ROW_TOL["rms"] or worst > ROW_TOL["worst"]:
            raise AssertionError(f"{cfg.name}: the capacity dispatch differs "
                                 f"from its rule at capacity factor {cf}")
        del got, want
    if drops[0.9] == 0:
        raise AssertionError(f"{cfg.name}: capacity factor 0.9 dropped no "
                             "pick; the check saw no overflow")
    return drops[cfg.capacity_factor]


def reference_forward():
    """The forward of the checks: the port's model, with the SSD scan's
    plain version in place of the kernel (the reference model's own math)
    so that a fault of the kernel cannot sit on both sides."""
    from repro_torch.models import ssm

    return swapped((ssm, "ssd_scan", plain_ssd))


def serve(cfg, smi, device="cuda", seed=0):
    """Drive one main path; returns (launch counts, engine stats)."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.models.lm import forward, init_params
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.steps import (greedy_oneshot, make_prefill_step,
                                   make_serve_step)

    phase = PHASES[arch_of(cfg)]
    traffic = phase["traffic"]
    paged_kernel = phase["paged_kernel"]
    counted = (*phase["kernels"], "rms_norm")
    cuda = device == "cuda"
    moe = any(spec.mlp == "moe" for spec in cfg.pattern)
    slots, cache_len, n_req, gen = (traffic[k] for k in (
        "slots", "cache_len", "n_req", "gen"))
    rng = np.random.default_rng(seed)
    if traffic["each"]:
        lens = rng.permutation(np.repeat(traffic["lens"],
                                         n_req // len(traffic["lens"])))
    else:
        lens = rng.choice(traffic["lens"], n_req)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    gaps = rng.exponential(0.03, n_req)

    box = {}

    def weights():                      # the engine's weights task
        t = time.perf_counter()
        box["params"] = init_params(
            cfg, torch.Generator(device).manual_seed(seed), device)
        for blk in box["params"]["blocks"]:
            if "conv_w" in blk["mixer"]:
                blk["mixer"]["conv_w"].mul_(SSM_CONV_W_GAIN)
        if cuda:
            torch.cuda.synchronize()
        box["weights_s"] = time.perf_counter() - t
        return box["params"]

    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for name in counted:
        getattr(kernels, name).launches.reset()
    t0 = time.perf_counter()
    with ServeEngine(cfg, weights, slots=slots, cache_len=cache_len,
                     page_size="auto", paged_kernel=paged_kernel,
                     sync_ticks=True, device=device) as eng:
        reqs = [Request(i, prompts[i], max_new_tokens=gen)
                for i in range(n_req)]
        for r, g in zip(reqs, gaps):
            eng.submit(r)
            time.sleep(float(g))
        eng.close()
        eng.join()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = eng.stats()
    eng = None                          # drop the pool before what follows
    launches = {name: getattr(kernels, name).launches.value
                for name in counted}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    params = box["params"]
    for r in reqs:
        toks = r.wait()
        if len(toks) != gen:
            raise AssertionError(f"request {r.rid}: {len(toks)} tokens")
    log(f"serve: {cfg.name} d {cfg.d_model} layers {cfg.n_layers} "
        f"{cfg.dtype}, "
        f"{n_req} requests x {gen} tokens, {slots} slots, cache_len "
        f"{cache_len}, page_size {stats['page_size']}, paged_kernel "
        f"{paged_kernel}; decode dispatches "
        f"{stats['decode_dispatches']}, prefill calls "
        f"{stats['prefill_calls']}, launches {launches}")
    log(f"serve figures ({cfg.name}, {smi}): tokens_s "
        f"{stats['tokens_out'] / wall:.2f} "
        f"wall_s {wall:.3f} p50_ttft_s {stats['p50_ttft_s']:.4f} "
        f"p50_tick_s {stats['p50_tick_s']:.4f} p99_tick_s "
        f"{stats['p99_tick_s']:.4f} peak_mem_gb {peak / 1e9:.2f} "
        f"(weights task included: {box['weights_s']:.2f} s)")
    if moe:
        check_capacity_dispatch(cfg, params, device)
    if cuda:
        steps_alone(cfg, params, smi, paged_kernel, traffic)

    # teacher-forced forward over prompt + emitted[:-1]: the gap is how
    # far each emitted token's logit trails that forward's max.  With MoE
    # the forward takes the expert ids of the step path as built (one run
    # of it recorded first): at random init, bf16 rounding differences
    # between any two computations flip near-tied top-2 choices, each flip
    # moves a token's MoE output by O(1), and neither check could tell a
    # fault from that.  The route check holds which experts the path
    # picks wherever the forward's own choice is clear (``ROUTE_MARGIN``,
    # ``ROUTE_MARGIN_FIRST``);
    # the CPU tests hold them to the reference (tests/test_torch_moe.py).
    # Everything else, the pick weights included, the forward computes
    # itself.
    toks_all = [np.asarray(r.out_tokens, np.int32) for r in reqs]
    plist = [prompts[r.rid] for r in reqs]
    routes = flips = None
    if moe:
        flips = []
        routes = recorded_routes(cfg, params, plist, toks_all, device, phase)
    ref, gaps_all, top2, spread, exact = [], [], [], [], 0
    for k, (r, toks) in enumerate(zip(reqs, toks_all)):
        seq = np.concatenate([prompts[r.rid], toks[:-1]])
        with reference_forward(), routes_forced(routes[k], flips) \
                if moe else contextlib.nullcontext():
            lg = forward(params, cfg, torch.tensor(seq[None], device=device),
                         mode="train")["logits"][0, len(prompts[r.rid]) - 1:]
        lg = lg.float()
        if tuple(lg.shape) != (gen, cfg.vocab) or \
                not torch.isfinite(lg).all():
            raise AssertionError(f"request {r.rid}: bad logits "
                                 f"{tuple(lg.shape)}")
        ref.append(lg)
        t = torch.tensor(toks, device=device).long()
        gap = lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0]
        exact += int((lg.argmax(dim=-1) == t).sum().item())
        gaps_all.append(gap.cpu())
        v2 = lg.topk(2, dim=-1).values
        top2.append((v2[:, 0] - v2[:, 1]).cpu())
        spread.append(lg.std(dim=-1).cpu())
    gaps_all = torch.cat(gaps_all)
    top2, spread = torch.cat(top2), torch.cat(spread)
    worst = gaps_all.max().item()
    q = torch.quantile(gaps_all, torch.tensor([0.5, 0.99])).tolist()
    log(f"teacher-forced ({cfg.name}): {exact}/{n_req * gen} emitted tokens "
        f"are the forward's argmax; gap p50 {q[0]:.4f} p99 {q[1]:.4f} max "
        f"{worst:.4f} (tolerance {LOGIT_TOL}); forward's top-2 margin p50 "
        f"{top2.median().item():.4f}, logit std p50 "
        f"{spread.median().item():.4f}")
    peak_checks = torch.cuda.max_memory_allocated() if cuda else 0
    built, route_missed = {"wide_flips": 0}, []
    if moe:
        n_moe = moe_layers(cfg)
        starts = [len(x) - 1 for x in plist]
        built = route_check(flips, n_moe, starts)
        log(route_line(f"route check [{cfg.name}, as built]", built))
        del routes, flips
        # planted in the routing: recorded from the path under the fault
        # and forced on the forward, over one round of requests
        for fault in ROUTE_FAULTS:
            k_f = min(slots, n_req)
            routes = recorded_routes(cfg, params, plist[:k_f],
                                     toks_all[:k_f], device, phase, fault)
            flips = []
            for k in range(k_f):
                seq = np.concatenate([plist[k], toks_all[k][:-1]])
                with reference_forward(), routes_forced(routes[k], flips):
                    forward(params, cfg, torch.tensor(seq[None],
                                                      device=device),
                            mode="train")
            f = route_check(flips, n_moe, starts[:k_f])
            log(route_line(f"route check [{cfg.name}, {fault}]", f))
            if f["wide_flips"] == 0:
                route_missed.append(fault)
            del routes, flips

    # logit check of the step path, as built and with each planted fault
    res = path_check(cfg, params, plist, toks_all, ref, device,
                     paged_kernel, slots=slots, cache_len=cache_len)
    del ref
    for n, m in res.items():
        log(f"logit check [{cfg.name}, {n or 'as built'}]: worst position "
            f"rel err {m['rel_max']:.4f} (tolerance {REL_TOL}), all "
            f"positions {m['rel']:.4f}, off the path as built by "
            f"{m['effect']:.4f}; its argmax trails the forward's by at most "
            f"{m['gap']:.4f} (token tolerance {LOGIT_TOL}); "
            f"{m['same']}/{n_req * gen} equal the engine's tokens")

    # for information: engine tokens against the port's one-shot path
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    step = make_serve_step(cfg)
    same = 0
    for n in sorted(set(lens.tolist())):      # one batch per length
        idx = [i for i in range(n_req) if lens[i] == n]
        ps = torch.tensor(np.stack([prompts[i] for i in idx]),
                          device=device)
        ref = greedy_oneshot(prefill, step, params, ps, None, gen).cpu()
        for j, i in enumerate(idx):
            same += int((ref[j].numpy()
                         == np.asarray(reqs[i].out_tokens)).sum())
    log(f"one-shot agreement (information, {cfg.name}): {same}/"
        f"{n_req * gen} engine tokens equal the port's greedy_oneshot "
        "tokens")
    if worst > LOGIT_TOL:
        raise AssertionError(f"{cfg.name}: an emitted token trails the "
                             f"forward's argmax by {worst:.4f} > {LOGIT_TOL}")
    if res[None]["rel_max"] > REL_TOL:
        raise AssertionError(f"{cfg.name}: step path logits off the "
                             f"forward's by {res[None]['rel_max']:.4f} > "
                             f"{REL_TOL}")
    if built["wide_flips"]:
        raise AssertionError(
            f"{cfg.name}: the step path's experts differ from the forward's "
            f"own at {built['wide_flips']} (layer, position) pairs whose "
            f"margin is above the bound")
    missed = route_missed + [n for n in res if n is not None and (
        res[n]["rel_max"] <= REL_TOL or res[n]["gap"] <= LOGIT_TOL)]
    if missed:
        raise AssertionError(f"{cfg.name}: the checks do not reject the "
                             f"planted faults {missed}")
    log(f"phase {cfg.name}: {time.perf_counter() - t_phase:.1f} s; peak "
        f"device memory of the teacher-forced forward "
        f"{peak_checks / 1e9:.2f} GB")
    return launches, stats


def check_launches(cfg, launches, stats):
    """The phase's launch identities: each kernel once per layer of each
    decode dispatch (paged attention) or prefill call (SSD scan, flash
    attention), or never (a kernel the phase's path must not take);
    RMSNorm at every norm site of every tick and prefill call."""
    phase = PHASES[arch_of(cfg)]
    want = {k: cfg.n_layers * stats[per] if per else 0
            for k, per in phase["kernels"].items()}
    want["rms_norm"] = (phase["norms"] * cfg.n_layers + 1) * (
        stats["decode_dispatches"] + stats["prefill_calls"])
    for name, n in want.items():
        if launches[name] != n or (n <= 0 and phase["kernels"].get(name,
                                                                   True)):
            raise AssertionError(f"{cfg.name}: {name} launches "
                                 f"{launches[name]} != {n} (identity of "
                                 "the main path)")
    parts = [f"{k} {launches[k]} = " + (
        f"{cfg.n_layers} x {stats[per]} {per}" if per else "0 (not on "
        "this path)") for k, per in phase["kernels"].items()]
    log(f"launch identities ({cfg.name}): " + "; ".join(parts)
        + f"; rms_norm {launches['rms_norm']} = "
        f"{phase['norms'] * cfg.n_layers + 1} x "
        f"({stats['decode_dispatches']} + {stats['prefill_calls']})")


def build_all():
    """Every kernel library built at once: one ``nvcc`` per source, started
    together, then the Triton kernel compiled by a first call."""
    import threading

    import torch

    from repro_torch.kernels import build, rms_norm
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops

    t0 = time.perf_counter()
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:            # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(fn,)) for fn in (
        paged_ops.library, paged_ops.mla_library, ssd_ops.library,
        flash_ops.library)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    t_nvcc = time.perf_counter() - t0
    x = torch.ones(2, 64, device="cuda")
    rms_norm(x, torch.ones(64, device="cuda"))          # Triton compiles
    torch.cuda.synchronize()
    log(f"build: four nvcc builds in parallel, all ready in {t_nvcc:.2f} s; "
        f"triton first call {time.perf_counter() - t0 - t_nvcc:.2f} s")
    for name, info in build.build_log.items():
        log(f"  {name}: nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log("    ptxas:", line.strip())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=0,
                    help="cut every serve phase to this depth (0: full "
                         "depth; width is never cut)")
    args = ap.parse_args(argv)

    smi = card()
    import torch

    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    build_all()
    rows = [check_paged_decode(), check_rms_norm(), check_paged_mla(),
            check_ssd(), *check_flash()]
    log(f"clocks after the kernel timings (sm, power, temp): {clocks()}")
    from repro_torch.configs import get

    launches = {}
    for arch, phase in PHASES.items():
        cfg = get(arch)
        layers = args.layers or phase.get("layers", cfg.n_layers)
        if layers != cfg.n_layers:
            log(f"depth cut: {layers} of {cfg.n_layers} layers ({arch})")
            cfg = cfg.replace(n_layers=layers)
        cfg = cfg.replace(moe_impl=phase.get("moe_impl", cfg.moe_impl))
        got, stats = serve(cfg, smi)
        check_launches(cfg, got, stats)
        for name, n in got.items():         # RMSNorm: every phase's sum
            launches[name] = launches.get(name, 0) + n
        torch.cuda.empty_cache()            # the next phase's weights
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    keys = ["name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"]
    extra = ["shape", "device_ms", "library_device_ms"]
    log(json.dumps({"kernels": [{k: row[k] for k in keys + extra if k in row}
                                for row in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
