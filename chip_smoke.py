#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # the whole run, from a checkout
    python3 chip_smoke.py --layers 8   # cut depth (width is never cut)

Phases (each raises on failure, so the script exits non-zero):

1. card   — requires ``torch.cuda.is_available()``; prints
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. build  — builds the CUDA kernel from ``src/repro_torch/csrc`` with
   ``nvcc`` (sm_90a), then the Triton kernel; prints the seconds.
3. kernels — each kernel's wrapper against its plain PyTorch version on
   the card: the paged-decode kernel at qwen2.5-14b decode shapes and the
   edge cases of the reference's kernel tests, RMSNorm at the main path's
   and the reference's shapes; then CUDA-event times of kernel, plain
   version and one PyTorch library call, beside the least time the card
   could take (``bound_ms``).
4. serve  — the port's main path at full width: qwen2.5-14b (d 5120,
   48 layers, bf16, seeded weights made on the card by the engine's
   weights task) behind ``repro_torch.serve.ServeEngine`` on the UMT
   runtime, paged KV pool (page size auto = 8) and ``paged_kernel=True``;
   32 requests with prompt lengths from {256, 512, 1024, 2048}, 32 tokens
   each, staggered arrivals, 16 slots.  Launch counters are zeroed right
   before and read right after.  Then the teacher-forced checks: one
   forward of the port over prompt + emitted tokens must put each emitted
   token at (or within ``LOGIT_TOL`` of) its argmax, and the engine's step
   path fed the same tokens must give that forward's logits within
   ``REL_TOL`` at every position — while each fault planted in the decode
   path (``PLANTED``) must fail both checks.
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

# the reference's kernel-test tolerances (tests/test_kernels.py:15-17)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
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
# Faults planted in the decode path as controls: each must fail both the
# token check and the logit check, or the checks prove nothing.
PLANTED = ("rope_pos_plus_1", "kv_group_order", "slot_pos_rolled",
           "newest_kv_left_out")


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


def clocks():
    """SM clock, power draw and temperature right now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def close(got, want, dtype, what):
    import torch

    tol = TOL[str(dtype).replace("torch.", "")]
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"{what}: kernel vs plain max |err| {err:.3e} "
                             f"outside rtol/atol {tol['rtol']}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    return err


# ------------------------------------------------------------ paged decode
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

    f32, bf16 = torch.float32, torch.bfloat16
    n = 0
    # the reference's grid (tests/test_kernels.py:99-121) in both dtypes
    for dt in (f32, bf16):
        for shape in [(2, 4, 4, 32, 16, 4), (3, 8, 2, 64, 32, 8),
                      (2, 4, 1, 32, 16, 2), (2, 6, 3, 16, 12, 1),
                      (1, 2, 2, 32, 8, 8)]:
            args, kw = paged_case(*shape, dt, seed=7)
            close(kern(*args, **kw), plain(*args, **kw), dt,
                  f"paged grid {shape} {dt}")
            n += 1
        # every GQA group size in REGISTRY (1, 2, 4, 5, 6, 8, 12)
        for g in (1, 2, 4, 5, 6, 8, 12):
            for dh in (64, 128):
                args, kw = paged_case(3, 2 * g, 2, dh, 40, 8, dt, seed=g)
                close(kern(*args, **kw), plain(*args, **kw), dt,
                      f"paged group {g} dh {dh} {dt}")
                n += 1
    # windows (tests/test_kernels.py:123-137)
    for w in (1, 3, 7, 100):
        args, kw = paged_case(3, 4, 2, 32, 24, 4, f32, seed=8, window=w)
        close(kern(*args, **kw), plain(*args, **kw), f32, f"window {w}")
        n += 1
    # poisoned garbage page must be inert (:165-182)
    args, kw = paged_case(3, 4, 2, 32, 16, 4, f32, seed=10,
                          pos=[0, 5, 15])
    q, kp, vp, table, pos = args
    clean = kern(*args, **kw)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0] = 1e4
    vp2[0] = 1e4
    poisoned = kern(q, kp2, vp2, table, pos, **kw)
    if not torch.equal(clean, poisoned) or \
            not torch.isfinite(poisoned).all():
        raise AssertionError("garbage page leaked into the kernel output")
    n += 1
    # allocated-but-future pages are masked (:185-201)
    args, kw = paged_case(2, 2, 2, 16, 16, 4, f32, seed=11, pos=[2, 9],
                          garbage_rest=False)
    close(kern(*args, **kw), plain(*args, **kw), f32, "future pages")
    n += 1

    # qwen2.5-14b decode shapes: 16 slots, Hkv 8, group 5, Dh 128, ps 8,
    # cache_len 2080, ragged pos up to 2079 (prompt lengths of the serve
    # phase + up to 31 generated tokens)
    rng = np.random.default_rng(0)
    qpos = (rng.choice([256, 512, 1024, 2048], 16)
            + rng.integers(0, 32, 16) - 1)
    qpos[0] = 2079
    errs = {}
    for dt in (f32, bf16):
        args, kw = paged_case(16, 40, 8, 128, 2080, 8, dt, seed=1,
                              pos=qpos)
        errs[dt] = close(kern(*args, **kw), plain(*args, **kw), dt,
                         f"qwen shapes {dt}")
        n += 1
    log(f"paged_decode: {n} cases match the plain version "
        f"(f32 rtol/atol 2e-5, bf16 2e-2); qwen shapes max|err| "
        f"f32 {errs[f32]:.3e} bf16 {errs[bf16]:.3e}")

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
        f"{bound:.4f} ({bound_by}: {nbytes} B)")
    return {"name": "paged_decode_attention", "route": "cuda",
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
    shapes = [(16, 1, 5120), (16 * 2048, 5120), (128, 256), (4, 32, 512),
              (1, 64)]
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


# ------------------------------------------------------------- main path
def steps_alone(cfg, params, smi, slots=16, cache_len=2080, ps=8):
    """Where a tick's time goes: one decode tick and one prefill of the
    main path's shapes, run alone (no engine, no other thread), host-timed
    around a synchronize, and the decode tick once more under
    torch.profiler for the device's busy time by kernel."""
    import numpy as np
    import torch

    from repro_torch.steps import (init_paged_slot_cache, make_decode_step,
                                   make_prefill_step)

    rng = np.random.default_rng(5)
    pps = cache_len // ps
    num_pages = 1 + slots * pps
    cache = init_paged_slot_cache(cfg, slots, cache_len, torch.bfloat16, ps,
                                  num_pages, "cuda")
    pos = rng.choice([256, 512, 1024, 2048], slots) + rng.integers(0, 31,
                                                                   slots)
    pos_dev = torch.tensor(pos.astype(np.int32), device="cuda")
    cache["pos"] = pos_dev.clone()
    table = torch.tensor(rng.permutation(np.arange(1, num_pages))
                         .reshape(slots, pps).astype(np.int32),
                         device="cuda")
    toks = torch.tensor(rng.integers(0, cfg.vocab, (slots, 1))
                        .astype(np.int32), device="cuda")
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    decode = make_decode_step(cfg, cache_len=cache_len, page_size=ps,
                              paged_kernel=True)

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
    ptoks = torch.tensor(rng.integers(0, cfg.vocab, (1, 2048))
                         .astype(np.int32), device="cuda")
    pre_ms = host_ms(lambda: prefill(params, ptoks), 2)
    log(f"steps alone ({smi}): decode tick (16 slots, paged kernel) "
        f"{tick_ms:.2f} ms host; device busy {busy:.2f} ms in one "
        f"profiled tick; prefill (1 x 2048) {pre_ms:.2f} ms host")
    for key, ms, n in rows[:8]:
        log(f"  tick kernel {ms:8.3f} ms x{n:5d}  {key[:90]}")


@contextlib.contextmanager
def planted(fault):
    """The decode path with one fault of ``PLANTED`` swapped into the
    attention module (``None``: as it is)."""
    from repro_torch.models import attention as att

    rope, kern = att.apply_rope, att.paged_decode_attention

    def rope_pos_plus_1(x, pos, theta=10_000.0):
        return rope(x, pos + 1, theta)

    def kv_group_order(q, kp, vp, table, pos, **kw):
        # flat head h reads kv head h % Hkv instead of h // group
        b, _, h, dh = q.shape
        g = h // kp.shape[2]
        qs = q.view(b, 1, g, h // g, dh).transpose(2, 3).reshape(q.shape)
        o = kern(qs.contiguous(), kp, vp, table, pos, **kw)
        return o.view(b, 1, h // g, g, dh).transpose(2, 3).reshape(q.shape)

    def slot_pos_rolled(q, kp, vp, table, pos, **kw):
        return kern(q, kp, vp, table, pos.roll(1), **kw)

    def newest_kv_left_out(q, kp, vp, table, pos, **kw):
        return kern(q, kp, vp, table, pos - 1, **kw)

    swap = {"rope_pos_plus_1": ("apply_rope", rope_pos_plus_1),
            "kv_group_order": ("paged_decode_attention", kv_group_order),
            "slot_pos_rolled": ("paged_decode_attention", slot_pos_rolled),
            "newest_kv_left_out": ("paged_decode_attention",
                                   newest_kv_left_out)}.get(fault)
    if fault is not None and swap is None:
        raise KeyError(fault)
    if swap is not None:
        setattr(att, *swap)
    try:
        yield
    finally:
        att.apply_rope, att.paged_decode_attention = rope, kern


def path_check(cfg, params, prompts, toks, ref, device, slots=16,
               cache_len=2080, ps=8):
    """The engine's step path teacher-forced with its emitted tokens: each
    prompt through the prefill step and the paged insert, then the tokens
    one tick at a time through the paged-kernel decode forward, ``slots``
    requests per round — as plain and under each planted fault.  Returns
    name -> {"rel": aggregate relative logit error against ``ref``,
    "rel_max": worst position, "effect": the same distance from the path
    as built, "gap": worst gap of the path's argmax under ``ref``,
    "same": path argmax equal to the emitted token}."""
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
             "kernel": True}
    names = [None, *PLANTED]
    acc = {n: {"d2": 0.0, "r2": 0.0, "e2": 0.0, "rel_max": 0.0, "gap": 0.0,
               "same": 0} for n in names}
    gen = len(toks[0])
    for r0 in range(0, len(prompts), slots):
        idx = list(range(r0, min(r0 + slots, len(prompts))))
        first = []
        for s, i in enumerate(idx):
            rows, lg = prefill(p, torch.tensor(prompts[i][None],
                                               device=device))
            cache = insert(cache, rows, 0, s, table[s])
            first.append(lg[0, -1].float())
        pad = slots - len(idx)
        pos0 = torch.tensor([len(prompts[i]) for i in idx] + [0] * pad,
                            dtype=torch.int32, device=device)
        feed = torch.tensor(np.stack([toks[i] for i in idx]
                                     + [np.zeros(gen, np.int32)] * pad),
                            device=device)
        for n in names:
            rows = [torch.stack(first)]
            with planted(n):
                for j in range(gen - 1):
                    o = forward(p, cfg, feed[:, j:j + 1], mode="decode",
                                pos=pos0 + j, cache=cache, pages=pages)
                    rows.append(o["logits"][:len(idx), 0].float())
            lg = torch.stack(rows, dim=1)               # (round, gen, V)
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
    return {n: {"rel": (a["d2"] / a["r2"]) ** 0.5, "rel_max": a["rel_max"],
                "effect": (a["e2"] / a["r2"]) ** 0.5, "gap": a["gap"],
                "same": a["same"]} for n, a in acc.items()}


def serve(cfg, smi, device="cuda", seed=0):
    """Drive the main path; returns (launch counts, engine stats)."""
    import numpy as np
    import torch

    from repro_torch.kernels import paged_decode_attention, rms_norm
    from repro_torch.models.lm import forward, init_params
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.steps import (greedy_oneshot, make_prefill_step,
                                   make_serve_step)

    cuda = device == "cuda"
    slots, cache_len, n_req, gen = 16, 2080, 32, 32
    rng = np.random.default_rng(seed)
    lens = rng.choice([256, 512, 1024, 2048], n_req)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    gaps = rng.exponential(0.03, n_req)

    box = {}

    def weights():                      # the engine's weights task
        t = time.perf_counter()
        box["params"] = init_params(
            cfg, torch.Generator(device).manual_seed(seed), device)
        if cuda:
            torch.cuda.synchronize()
        box["weights_s"] = time.perf_counter() - t
        return box["params"]

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    paged_decode_attention.launches.reset()
    rms_norm.launches.reset()
    t0 = time.perf_counter()
    with ServeEngine(cfg, weights, slots=slots, cache_len=cache_len,
                     page_size="auto", paged_kernel=True, sync_ticks=True,
                     device=device) as eng:
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
    launches = {"paged_decode_attention": paged_decode_attention.launches
                .value, "rms_norm": rms_norm.launches.value}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    params = box["params"]
    for r in reqs:
        toks = r.wait()
        if len(toks) != gen:
            raise AssertionError(f"request {r.rid}: {len(toks)} tokens")
    log(f"serve: {cfg.name} d {cfg.d_model} layers {cfg.n_layers} "
        f"{cfg.dtype}, "
        f"{n_req} requests x {gen} tokens, {slots} slots, cache_len "
        f"{cache_len}, page_size {stats['page_size']}; decode dispatches "
        f"{stats['decode_dispatches']}, prefill calls "
        f"{stats['prefill_calls']}, launches {launches}")
    log(f"serve figures ({smi}): tokens_s {stats['tokens_out'] / wall:.2f} "
        f"wall_s {wall:.3f} p50_ttft_s {stats['p50_ttft_s']:.4f} "
        f"p50_tick_s {stats['p50_tick_s']:.4f} p99_tick_s "
        f"{stats['p99_tick_s']:.4f} peak_mem_gb {peak / 1e9:.2f} "
        f"(weights task included: {box['weights_s']:.2f} s)")
    if cuda:
        steps_alone(cfg, params, smi)

    # teacher-forced forward over prompt + emitted[:-1]: the gap is how
    # far each emitted token's logit trails that forward's max
    toks_all = [np.asarray(r.out_tokens, np.int32) for r in reqs]
    ref, gaps_all, top2, spread, exact = [], [], [], [], 0
    for r, toks in zip(reqs, toks_all):
        seq = np.concatenate([prompts[r.rid], toks[:-1]])
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
    log(f"teacher-forced: {exact}/{n_req * gen} emitted tokens are the "
        f"forward's argmax; gap p50 {q[0]:.4f} p99 {q[1]:.4f} max "
        f"{worst:.4f} (tolerance {LOGIT_TOL}); forward's top-2 margin p50 "
        f"{top2.median().item():.4f}, logit std p50 "
        f"{spread.median().item():.4f}")

    # logit check of the step path, plain and with each planted fault
    res = path_check(cfg, params, [prompts[r.rid] for r in reqs], toks_all,
                     ref, device, slots=slots, cache_len=cache_len)
    del ref
    for n, m in res.items():
        log(f"logit check [{n or 'as built'}]: worst position rel err "
            f"{m['rel_max']:.4f} (tolerance {REL_TOL}), all positions "
            f"{m['rel']:.4f}, off the path as built by {m['effect']:.4f}; "
            f"its argmax trails the forward's by at most {m['gap']:.4f} "
            f"(token tolerance {LOGIT_TOL}); {m['same']}/{n_req * gen} "
            "equal the engine's tokens")

    # for information: engine tokens against the port's one-shot path
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    step = make_serve_step(cfg)
    same = 0
    for n in sorted(set(lens.tolist())):
        idx = [i for i in range(n_req) if lens[i] == n]
        ps = torch.tensor(np.stack([prompts[i] for i in idx]),
                          device=device)
        ref = greedy_oneshot(prefill, step, params, ps, None, gen).cpu()
        for j, i in enumerate(idx):
            same += int((ref[j].numpy()
                         == np.asarray(reqs[i].out_tokens)).sum())
    log(f"one-shot agreement (information): {same}/{n_req * gen} engine "
        "tokens equal the port's greedy_oneshot tokens")
    if worst > LOGIT_TOL:
        raise AssertionError(f"an emitted token trails the forward's argmax "
                             f"by {worst:.4f} > {LOGIT_TOL}")
    if res[None]["rel_max"] > REL_TOL:
        raise AssertionError(f"step path logits off the forward's by "
                             f"{res[None]['rel_max']:.4f} > {REL_TOL}")
    missed = [n for n in PLANTED if res[n]["rel_max"] <= REL_TOL
              or res[n]["gap"] <= LOGIT_TOL]
    if missed:
        raise AssertionError(f"the checks do not reject the planted faults "
                             f"{missed}")
    return launches, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=48,
                    help="model depth for the serve phase (width is never "
                         "cut)")
    args = ap.parse_args(argv)

    smi = card()
    import torch

    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.rmsnorm import rms_norm

    t0 = time.perf_counter()
    paged_ops.library()                                 # nvcc
    t_nvcc = time.perf_counter() - t0
    x = torch.ones(2, 64, device="cuda")
    rms_norm(x, torch.ones(64, device="cuda"))          # Triton compiles
    torch.cuda.synchronize()
    info = build.build_log["paged_decode"]
    log(f"build: nvcc {info['seconds']:.2f} s (library ready in "
        f"{t_nvcc:.2f} s), triton first call "
        f"{time.perf_counter() - t0 - t_nvcc:.2f} s")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    rows = [check_paged_decode(), check_rms_norm()]
    log(f"clocks after the kernel timings (sm, power, temp): {clocks()}")
    from repro_torch.configs import get

    cfg = get("qwen2.5-14b")
    if args.layers != cfg.n_layers:
        log(f"depth cut: {args.layers} of {cfg.n_layers} layers")
        cfg = cfg.replace(n_layers=args.layers)
    launches, stats = serve(cfg, smi)
    if launches["paged_decode_attention"] != \
            cfg.n_layers * stats["decode_dispatches"]:
        raise AssertionError(
            f"paged-decode launches {launches['paged_decode_attention']}"
            f" != {cfg.n_layers} x {stats['decode_dispatches']} "
            "decode dispatches")
    if launches["rms_norm"] <= 0:
        raise AssertionError("no RMSNorm kernel launch on the main path")
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ["name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"]
    log(json.dumps({"kernels": [{k: row[k] for k in keys}
                                for row in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
