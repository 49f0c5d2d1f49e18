"""One (arch x shape) cell on the card, cut to fit, beside what it should
cost (PyTorch port of ``repro/launch/profile_cell.py``).

    PYTHONPATH=src python -m repro_torch.launch.profile_cell \
        --arch mamba2-780m --shape train_4k --batch 4 --seq 1024 --accum 1

The cell's step (``dryrun.cell_step``) runs on seeded weights and random
tokens on the card (without one it raises), at the registry's config and
``SHAPES`` entry less the cuts the flags ask for (``--layers``,
``--batch``, ``--seq``, ``--accum``; each cut is printed), with
``--remat`` and ``--moe-impl`` where given.  Printed:
``op_cost`` of the same cut cell on meta (``launch/op_cost.py``); one
call after a warm-up under ``torch.profiler``: host ms, device-busy ms
and the 12 kernels that took the most device time (the counterpart of
the reference's "bytes by op"); the launches of the port's kernels in
that call; the ``Roofline`` bound of the meta counts (``launch/
analysis.py``) and the share bound / device ms; the meta peak estimate
(arguments + op-allocated peak) beside ``torch.cuda.max_memory_allocated
()``.  On meta the wrappers take their plain versions, and ``OpCost``
charges each of their calls as the kernel's own work and results
(``kernels/counter.kernel_site``): flash attention's causal half and no
score matrix, so the bound and the peak are those of the kernels the
card runs.  ``--multi-pod`` adds the cut cell's collectives on the
2x16x16 production mesh by kind (count, bytes moved per chip,
``t_collective``; ``profile(multi_pod=False)``: on 16x16), counted by a
meta pass of its sharded step on that mesh as a layout
(``dryrun.cell_inputs``, ``launch.mesh.make_production_mesh``), beside
the one-card profile: the card runs no
mesh here.  Train cells only; a serving cell's line says it waits for
ROADMAP.md item 20b.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import torch

from .. import kernels
from ..configs import SHAPES, get
from ..device import resolve_device
from ..models.lm import init_cache, init_params
from ..steps import init_train_state
from .analysis import Roofline, collective_stats
from .dryrun import SERVE_ON_MESH, cell_inputs, cell_step, mesh_name
from .mesh import make_production_mesh
from .op_cost import op_cost
from .specs import input_specs

# the port's kernel wrappers, whose launches a profiled call reports
COUNTED = ("flash_attention", "paged_decode_attention",
           "paged_mla_decode_attention", "rms_norm", "rms_norm_bwd",
           "ssd_scan", "ssd_scan_bwd")


def cut_cell(arch, shape_name, layers=0, batch=0, seq=0, accum=0,
             remat=None, moe_impl=None):
    """(cfg, shape, cuts): the registry's config and ``SHAPES`` entry with
    the cuts applied, and a line for each cut."""
    cfg, shape = get(arch), SHAPES[shape_name]
    cuts = []
    if layers and layers != cfg.n_layers:
        cuts.append(f"layers {cfg.n_layers} -> {layers}")
        cfg = cfg.replace(n_layers=layers)
    for name, val in (("batch", batch), ("seq", seq), ("accum", accum)):
        if val and val != getattr(shape, name):
            cuts.append(f"{name} {getattr(shape, name)} -> {val}")
            shape = dataclasses.replace(shape, **{name: val})
    if shape.batch % shape.accum:
        raise ValueError(f"batch {shape.batch} does not split into "
                         f"{shape.accum} microbatches")
    for name, val in (("remat", remat), ("moe_impl", moe_impl)):
        if val and val != getattr(cfg, name):
            cuts.append(f"{name} {getattr(cfg, name)} -> {val}")
            cfg = cfg.replace(**{name: val})
    return cfg, shape, cuts


def real_inputs(cfg, shape, device):
    """``input_specs``' keywords as tensors on ``device``: seed-0 weights
    (f32 masters and AdamW state for train, ``cfg.dtype`` to serve),
    random token ids, patches at std 0.02, a zero cache at position
    ``seq - 1``."""
    gen = torch.Generator(device).manual_seed(0)
    specs = input_specs(cfg, shape)

    def like(t, std=None):
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab, t.shape, generator=gen,
                                 device=device, dtype=torch.int32)
        return (torch.randn(t.shape, generator=gen, device=device) * std
                ).to(t.dtype)

    if shape.kind == "train":
        batch = {k: like(v, 0.02) for k, v in specs["batch"].items()}
        batch["labels"] = batch["tokens"]
        return {"state": init_train_state(cfg, gen, device=device),
                "batch": batch}
    out = {k: like(v, 0.02) for k, v in specs.items()
           if k not in ("params", "cache")}
    out["params"] = init_params(cfg, gen, device)
    if shape.kind == "decode":
        out["cache"] = init_cache(cfg, shape.batch, shape.seq,
                                  getattr(torch, cfg.dtype), device)
        out["cache"]["pos"].fill_(shape.seq - 1)
    return out


def _profiled(fn):
    """``fn`` twice under torch.profiler with a schedule of one warm-up
    step and one active step (the profiler can miss a window's first
    launches): (host s, device-busy s, [(kernel, ms)] largest first) of
    the active call, timed between two synchronizes.  The port runs on
    one stream, so its kernels add up to the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        prof.step()
    by = collections.Counter()
    for e in prof.events():
        # the step's own range also shows on the device's timeline
        # ("ProfilerStep*", a user annotation): it is no kernel
        if e.device_type == DeviceType.CUDA and not (
                e.name.startswith("ProfilerStep")
                or getattr(e, "is_user_annotation", False)):
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ").strip()
            by[name[:64]] += e.time_range.elapsed_us()
    return host, sum(by.values()) / 1e6, [(k, v / 1e3)
                                          for k, v in by.most_common()]


def mesh_collectives(cfg, shape, multi_pod):
    """The collectives of ``cfg``'s ``shape`` train step on a production
    mesh (``multi_pod``: 2x16x16, else 16x16), from one meta pass of the
    step on the layout at rank 0's local shapes: an
    ``analysis.CollectiveStats``."""
    mesh = make_production_mesh(multi_pod)
    cell_step(cfg, shape, mesh)(**cell_inputs(cfg, shape, mesh)[1])
    return collective_stats(mesh.records)


def collectives_line(cfg, shape, multi_pod):
    """``mesh_collectives`` as one printed line, or why there is none."""
    where = mesh_name(multi_pod)
    if shape.kind != "train":
        return f"collectives on {where}: skipped ({SERVE_ON_MESH})"
    try:
        st = mesh_collectives(cfg, shape, multi_pod)
    except NotImplementedError as e:
        return f"collectives on {where}: not run ({e})"
    rl = Roofline(0.0, 0.0, st.per_chip_bytes, 1)
    return (f"collectives on {where} (a meta pass, rank 0): " + ", ".join(
        f"{k} {n} calls {b:.4e} B a chip" for k, (n, b) in
        sorted(st.by_kind.items()))
        + f"; t_collective {rl.t_collective * 1e3:.3f} ms")


def profile(arch, shape_name, layers=0, batch=0, seq=0, accum=0,
            remat=None, moe_impl=None, multi_pod=None):
    """Profile one cut cell on the card; prints it and returns its figures
    as a dict.  ``multi_pod`` (not None): also the cell's collectives on
    the 2x16x16 (True) or 16x16 (False) production mesh, as a line."""
    device = resolve_device("cuda")
    cfg, shape, cuts = cut_cell(arch, shape_name, layers, batch, seq, accum,
                                remat, moe_impl)
    print(f"== {arch} {shape_name} on {torch.cuda.get_device_name(device)} "
          f"==")
    print("cuts: " + ("; ".join(cuts) if cuts else "none"))
    step = cell_step(cfg, shape)
    t0 = time.perf_counter()
    _, cost = op_cost(step, **input_specs(cfg, shape))
    meta_s = time.perf_counter() - t0
    rl = Roofline(flops=cost.flops, hbm_bytes=cost.bytes_min)
    print(f"op_cost on meta ({meta_s:.1f} s): flops {cost.flops:.4e} "
          f"(matmul {cost.flops_matmul:.4e}, kernels' sites "
          f"{cost.flops_kernels:.4e}), bytes_min "
          f"{cost.bytes_min:.4e}, bytes_fused {cost.bytes_fused:.4e}, "
          f"bytes {cost.bytes:.4e}; bound {rl.t_bound * 1e3:.3f} ms "
          f"({rl.bottleneck})")
    coll = (None if multi_pod is None
            else collectives_line(cfg, shape, multi_pod))
    if coll:
        print(coll)

    args = real_inputs(cfg, shape, device)
    step(**args)                               # builds, compiles, warms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    before = {k: getattr(kernels, k).launches.value for k in COUNTED}
    host_s, busy_s, top = _profiled(lambda: step(**args))
    # _profiled makes two calls, the same launches each
    launches = {k: (getattr(kernels, k).launches.value - before[k]) // 2
                for k in COUNTED}
    peak = torch.cuda.max_memory_allocated(device)
    est = cost.argument + cost.peak_temp
    device_ms = busy_s * 1e3
    share = rl.t_bound * 1e3 / device_ms if device_ms else None
    print(f"one call: host {host_s * 1e3:.2f} ms, device busy "
          f"{device_ms:.2f} ms (idle share "
          f"{max(0.0, 1 - busy_s / host_s):.3f}); bound "
          f"{rl.t_bound * 1e3:.3f} ms, share of the bound "
          f"{share if share is None else round(share, 4)}")
    print("-- device time by kernel (ms, one call) --")
    for name, ms in top[:12]:
        print(f"  {ms:10.3f}  {name}")
    print("launches in one call: " + ", ".join(
        f"{k} {n}" for k, n in launches.items() if n))
    print("kernels' sites on meta (calls, flops, bytes): " + ", ".join(
        f"{k} {n} / {f:.4e} / {b:.4e}"
        for k, (n, f, b) in sorted(cost.kernels.items())))
    print(f"peak memory: meta estimate {est / 1e9:.2f} GB (arguments "
          f"{cost.argument / 1e9:.2f} + op-allocated "
          f"{cost.peak_temp / 1e9:.2f}), max_memory_allocated "
          f"{peak / 1e9:.2f} GB")
    del args
    return {"arch": arch, "shape": shape_name, "cuts": cuts,
            "flops": cost.flops, "bytes_min": cost.bytes_min,
            "bound_ms": rl.t_bound * 1e3, "bottleneck": rl.bottleneck,
            "host_ms": host_s * 1e3, "device_ms": device_ms,
            "share": share, "top": top[:12], "launches": launches,
            "peak_meta": est, "peak": peak, "meta_s": meta_s,
            "collectives": coll}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth (0: the registry's)")
    ap.add_argument("--batch", type=int, default=0,
                    help="cut the global batch (0: the shape's)")
    ap.add_argument("--seq", type=int, default=0,
                    help="cut the sequence (0: the shape's)")
    ap.add_argument("--accum", type=int, default=0,
                    help="microbatches a train step (0: the shape's)")
    ap.add_argument("--remat", default=None,
                    choices=("none", "dots", "full"))
    ap.add_argument("--moe-impl", default=None,
                    choices=("onehot", "ragged"))
    ap.add_argument("--multi-pod", action="store_true",
                    help="print the cell's collectives on the 2x16x16 "
                         "production mesh")
    a = ap.parse_args(argv)
    return profile(a.arch, a.shape, a.layers, a.batch, a.seq, a.accum,
                   a.remat, a.moe_impl, True if a.multi_pod else None)


if __name__ == "__main__":
    main()
