"""What each (arch x shape) cell costs on one H100, without running it
(PyTorch port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        [--arch qwen2.5-14b] [--shape train_4k] [--no-probe] [--out f.jsonl]

Each cell calls the port's own step (``steps.make_train_step``,
``make_prefill_step`` or ``make_serve_step``) at its full configuration
on meta tensors (``launch/specs.py``) under ``OpCost``
(``launch/op_cost.py``): every layer and every microbatch runs as a
pass over shapes, so nothing is allocated on any device, and the cost is
counted from the aten ops that run.  The kernel wrappers take their
plain versions on meta, and each of their calls is charged as its
kernel's own work.  One JSON record a cell, the reference's keys,
with ``"device"`` in place of ``"mesh"`` and ``"trace_s"`` in place of
``"compile_s"``: ``bytes_per_device`` (argument, output, temp = the
op-allocated peak, peak = argument + temp), ``total_params``, and with
the probe the ``Roofline`` of ``launch/analysis.py`` (flops, and
``bytes_min`` as its HBM bytes), the fused and unfused byte counts,
``model_flops`` and ``useful_flops_ratio``.  ``--no-probe`` runs the
shape pass alone.  ``--out`` appends each record to a JSONL file and
skips the cells it already holds without an error.  Exits 1 if a cell
failed; the dropless MoE (``moe_impl="ragged"``) cannot run on meta
(``models.moe.DroplessOnMeta``).

Deviations from the reference: one card and no mesh, so no
``--multi-pod`` or ``--both-meshes`` and no collectives (the production
meshes, ROADMAP.md queue 1, item 20); aten-level counting in place
of HLO-level, so "fused" means elementwise ops left out, not a
compiler's fusion.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from ..configs import REGISTRY, SHAPES, get, shapes_for
from ..models.layers import tree_leaves
from ..steps import make_prefill_step, make_serve_step, make_train_step
from .analysis import Roofline, model_flops, total_params
from .op_cost import op_cost
from .specs import input_specs

DEVICE = "H100, one card"


def cell_step(cfg, shape):
    """The step of a cell; it takes ``input_specs``' keywords."""
    make = {"train": make_train_step, "prefill": make_prefill_step,
            "decode": make_serve_step}[shape.kind]
    return make(cfg)


def run_cell(arch: str, shape_name: str, verbose: bool = True,
             probe: bool = True) -> dict:
    cfg = get(arch)
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.subquadratic:
        return {"arch": arch, "shape": shape_name, "skipped":
                "full-attention arch; long_500k needs sub-quadratic"}
    specs = input_specs(cfg, shape)
    step = cell_step(cfg, shape)
    t0 = time.time()
    if probe:
        _, cost = op_cost(step, **specs)
        arg, out, temp = cost.argument, cost.output, cost.peak_temp
    else:
        step(**specs)
        cost = None
        arg = sum(t.numel() * t.element_size() for t in tree_leaves(specs))
        out = temp = None
    rec = {
        "arch": arch, "shape": shape_name, "device": DEVICE,
        "trace_s": round(time.time() - t0, 1),
        "bytes_per_device": {"argument": arg, "output": out, "temp": temp,
                             "peak": arg + (temp or 0)},
        "total_params": total_params(cfg),
    }
    if probe:
        rl = Roofline(flops=cost.flops, hbm_bytes=cost.bytes_min)
        mf = model_flops(cfg, shape)
        rec.update({
            "analysis_s": rec["trace_s"],
            "roofline": rl.as_dict(),
            "hbm_bytes_fused_global": cost.bytes_fused,
            "hbm_bytes_unfused_global": cost.bytes,
            "collectives": {},
            "model_flops": mf,
            "useful_flops_ratio": (mf / rl.flops) if rl.flops else None,
        })
    if verbose:
        print(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--no-probe", action="store_true",
                    help="the shape pass only, no cost counting")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    done = set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "error" not in r:
                    done.add((r["arch"], r["shape"]))

    archs = list(REGISTRY) if args.arch == "all" else [args.arch]
    results = []
    for arch in archs:
        cfg = get(arch)
        shapes = ([s.name for s in shapes_for(cfg)] if args.shape == "all"
                  else [args.shape])
        for sn in shapes:
            if (arch, sn) in done:
                print(f"skip cached {arch} {sn}")
                continue
            try:
                rec = run_cell(arch, sn, verbose=False,
                               probe=not args.no_probe)
            except Exception as e:  # noqa: BLE001 — recorded, exit 1 below
                rec = {"arch": arch, "shape": sn, "device": DEVICE,
                       "error": f"{type(e).__name__}: {e}"}
            results.append(rec)
            line = json.dumps(rec)
            print(line[:300], flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    errs = [r for r in results if "error" in r]
    print(f"\n{len(results) - len(errs)}/{len(results)} cells OK")
    if errs:
        for e in errs:
            print("ERROR:", e["arch"], e["shape"], e["error"][:200])
        raise SystemExit(1)


if __name__ == "__main__":
    main()
