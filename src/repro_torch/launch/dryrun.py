"""What each (arch x shape) cell costs on one H100, or per card on the
production meshes, without running it (PyTorch port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        [--arch qwen2.5-14b] [--shape train_4k] [--multi-pod | --both-meshes]
        [--no-probe] [--out f.jsonl]

Each cell calls the port's own step (``steps.make_train_step``,
``make_prefill_step`` or ``make_serve_step``) at its full configuration
on meta tensors (``launch/specs.py``) under ``OpCost``
(``launch/op_cost.py``): every layer and every microbatch runs as a
pass over shapes, so nothing is allocated on any device, and the cost is
counted from the aten ops that run.  The kernel wrappers take their
plain versions on meta, and each of their calls is charged as its
kernel's own work.  One JSON record a cell, the reference's keys, with
``"trace_s"`` in place of ``"compile_s"``: ``bytes_per_device``
(argument, output, temp = the op-allocated peak, peak = argument +
temp), ``total_params``, and with the probe the ``Roofline`` of
``launch/analysis.py`` (flops, and ``bytes_min`` as its HBM bytes), the
fused and unfused byte counts, ``collectives``, ``model_flops`` and
``useful_flops_ratio``.  ``--no-probe`` runs the shape pass alone.
``--out`` appends each record to a JSONL file and skips the cells it
already holds (keyed on arch, shape and mesh) without an error.  Exits 1
if a cell failed; the dropless MoE (``moe_impl="ragged"``) cannot run on
meta (``models.moe.DroplessOnMeta``).

Without ``--multi-pod`` or ``--both-meshes`` a cell runs on one card, as
the record's ``"device"`` says.  With them it runs on the reference's
production meshes, 16x16 and 2x16x16 (``"mesh"``): a layout, not 256
ranks (``launch.mesh.make_production_mesh``).  Rank 0's step runs on
its local shapes (``specs.input_specs(cfg, shape, mesh)``: the train
state cut over data and model, the batch's rows over pod x data; the
step is handed the whole batch, whose rows it cuts itself, on meta at no
cost), and every collective it meets is recorded, not run: the record
gains ``collectives`` by kind (count, bytes moved per chip by the ring
formulas, ``analysis.collective_stats``) and the roofline over
``chips`` with ``t_collective`` (``analysis.LINK_BW``, from the data
sheet).  ``bytes_per_device`` is rank 0's.  Train cells only: prefill
and decode cells on a production mesh come back ``"skipped"``, since
serving splits no data axis and the reference's decode splits the cache
by sequence (``DECODE_RULES``), which wait for ROADMAP.md item 20b.

Deviations from the reference: aten-level counting in place of
HLO-level, so "fused" means elementwise ops left out, not a compiler's
fusion; the collectives are the port's own, written out in its layers
and ``sharding.fsdp``, where the reference's are GSPMD's.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from ..configs import REGISTRY, SHAPES, get, shapes_for
from ..models.layers import tree_leaves
from ..steps import make_prefill_step, make_serve_step, make_train_step
from .analysis import Roofline, collective_stats, model_flops, total_params
from .mesh import make_production_mesh
from .op_cost import op_cost
from .specs import batch_specs, input_specs

DEVICE = "H100, one card"
SERVE_ON_MESH = ("serving cells on a production mesh wait for ROADMAP.md "
                 "item 20b: serving splits no data axis, and the "
                 "reference's decode splits the cache by sequence "
                 "(DECODE_RULES)")


def mesh_name(multi_pod):
    """A record's ``"mesh"``: None (one card), "16x16" or "2x16x16"."""
    return None if multi_pod is None else "2x16x16" if multi_pod else "16x16"


def cell_step(cfg, shape, mesh=None):
    """The step of a cell (on ``mesh``: a train cell's sharded step); it
    takes ``input_specs``' keywords."""
    if shape.kind == "train":
        return make_train_step(cfg, mesh=mesh)
    return {"prefill": make_prefill_step,
            "decode": make_serve_step}[shape.kind](cfg)


def cell_inputs(cfg, shape, mesh=None):
    """(the step's arguments at this rank's shapes, the keywords it is
    called with): on a mesh the sharded step cuts its rows from the whole
    batch, which it is handed (on meta, at no cost)."""
    specs = input_specs(cfg, shape, mesh)
    if mesh is None:
        return specs, specs
    return specs, dict(specs, batch=batch_specs(cfg, shape))


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def run_cell(arch: str, shape_name: str, multi_pod: bool | None = None,
             verbose: bool = True, probe: bool = True) -> dict:
    """One cell's record: on one card (``multi_pod`` None), or on the
    16x16 (False) or 2x16x16 (True) production mesh."""
    cfg = get(arch)
    shape = SHAPES[shape_name]
    where = ({"device": DEVICE} if multi_pod is None
             else {"mesh": mesh_name(multi_pod)})
    if shape.name == "long_500k" and not cfg.subquadratic:
        return {"arch": arch, "shape": shape_name, **where, "skipped":
                "full-attention arch; long_500k needs sub-quadratic"}
    if multi_pod is not None and shape.kind != "train":
        return {"arch": arch, "shape": shape_name, **where,
                "skipped": SERVE_ON_MESH}
    mesh = None if multi_pod is None else make_production_mesh(multi_pod)
    chips = 1 if mesh is None else mesh.size
    specs, call = cell_inputs(cfg, shape, mesh)
    step = cell_step(cfg, shape, mesh)
    t0 = time.time()
    if probe:
        _, cost = op_cost(step, **call)
        arg = cost.argument if mesh is None else _bytes(specs)
        out, temp = cost.output, cost.peak_temp
    else:
        step(**call)
        cost = None
        arg = _bytes(specs)
        out = temp = None
    rec = {
        "arch": arch, "shape": shape_name, **where,
        "trace_s": round(time.time() - t0, 1),
        "bytes_per_device": {"argument": arg, "output": out, "temp": temp,
                             "peak": arg + (temp or 0)},
        "total_params": total_params(cfg),
    }
    if probe:
        coll = collective_stats(mesh.records if mesh is not None else ())
        rl = Roofline(flops=cost.flops * chips,
                      hbm_bytes=cost.bytes_min * chips,
                      coll_bytes_per_chip=coll.per_chip_bytes, chips=chips)
        mf = model_flops(cfg, shape)
        rec.update({
            "analysis_s": rec["trace_s"],
            "roofline": rl.as_dict(),
            "hbm_bytes_fused_global": cost.bytes_fused * chips,
            "hbm_bytes_unfused_global": cost.bytes * chips,
            "collectives": {k: (v[0], v[1]) for k, v in
                            coll.by_kind.items()},
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
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 production mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the 16x16 and the 2x16x16 production meshes")
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
                    done.add((r["arch"], r["shape"], r.get("mesh")))

    archs = list(REGISTRY) if args.arch == "all" else [args.arch]
    meshes = ([False, True] if args.both_meshes
              else [True] if args.multi_pod else [None])
    results = []
    for arch in archs:
        cfg = get(arch)
        shapes = ([s.name for s in shapes_for(cfg)] if args.shape == "all"
                  else [args.shape])
        for sn in shapes:
            for mp in meshes:
                where = mesh_name(mp)
                if (arch, sn, where) in done:
                    print(f"skip cached {arch} {sn} {where or DEVICE}")
                    continue
                try:
                    rec = run_cell(arch, sn, mp, verbose=False,
                                   probe=not args.no_probe)
                except Exception as e:  # noqa: BLE001 — recorded, exit 1
                    rec = {"arch": arch, "shape": sn,
                           **({"device": DEVICE} if mp is None
                              else {"mesh": where}),
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
            print("ERROR:", e["arch"], e["shape"],
                  *([e["mesh"]] if "mesh" in e else []), e["error"][:200])
        raise SystemExit(1)


if __name__ == "__main__":
    main()
