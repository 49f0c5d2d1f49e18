"""The production meshes and the pod axis on the port: the reference's
16x16 ``("data", "model")`` and 2x16x16 ``("pod", "data", "model")``
meshes as layouts on meta (``launch.mesh.make_production_mesh``), the
dry run on them (``launch.dryrun``), and a pod axis on a real CPU mesh.

  * Per-device argument bytes of every ``REGISTRY`` family's ``train_4k``
    on both meshes (``launch.specs.input_specs(cfg, shape, mesh)``, the
    train state cut as the sharded step takes it) equal, leaf by leaf,
    the reference's rules: its ``input_specs(cfg, shape, None)``,
    ``state_axes`` / ``batch_axes`` and ``logical_spec(..., strict=True)``
    on a stand-in mesh of one device repeated.  The SSD mixer's
    ``TP_LOCAL`` leaves (a layout deviation, ROADMAP queue 3) are held to
    the port's own formula instead.
  * ``specs.to_shardings`` of the train cell's axes trees, and the
    decode cache's axes, equal the reference's, leaf by leaf.
  * The reference's ``test_dryrun_one_cell_compiles_on_production_mesh``
    the port's way: internvl2-2b ``train_4k`` on 16x16 gives a peak above
    0 and those argument bytes.
  * A layout mesh records what a real mesh runs: qwen2.5-14b-tiny at 10
    query and 2 KV heads, one train step on a real CPU 2,2 mesh and on a
    2,2 layout on meta, the same collectives by kind, count and bytes.
  * A real CPU 2,2,1 (pod, data, model) mesh trains one and two steps
    within ``tests/fsdp_ref.py``'s bars.
  * Serving cells on a production mesh come back ``"skipped"`` naming
    item 20b; ``--both-meshes --out`` writes two records a cell and
    resumes.
"""
import json

import jax
import numpy as np
import pytest
import torch

from fsdp_ref import MICRO, SEQ, mesh_train, misses, reference, run_mesh
from repro.configs import get as jget
from repro.launch import specs as jspecs
from repro.sharding.rules import logical_spec as jlogical_spec
from repro_torch.configs import REGISTRY, SHAPES, get
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (LayoutMesh, make_mesh_from_devices,
                                     make_production_mesh)
from repro_torch.launch.specs import batch_specs, input_specs, state_specs
from repro_torch.models.layers import tree_leaves
from repro_torch.models.ssm import TP_LOCAL, tp_local_width
from repro_torch.optim import OptHParams
from repro_torch.serve.tp import counters
from repro_torch.steps import make_train_step, train_plan

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
QWEN_10_2 = dict(n_heads=10, n_kv_heads=2)


def stand_in(multi_pod):
    """The reference's production mesh as ``tests/test_sharding_rules.py::
    _mesh`` builds one: one device repeated."""
    from jax.sharding import Mesh

    shape, axes = MESHES[multi_pod]
    devs = np.array([jax.devices()[0]] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, axes)


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def reference_bytes(arch, multi_pod):
    """Per leaf of the train cell's arguments (in ``tree_leaves`` order),
    the bytes one device holds by the reference's strict rules."""
    jcfg = jget(arch)
    specs, _ = jspecs.input_specs(jcfg, SHAPES["train_4k"], None)
    axes = {"state": jspecs.state_axes(jcfg),
            "batch": jspecs.batch_axes(jcfg)}
    mesh = stand_in(multi_pod)

    def local(ax, sds):
        spec = tuple(jlogical_spec(sds.shape, ax, mesh, strict=True))
        n = np.dtype(sds.dtype).itemsize
        for d, part in zip(sds.shape, spec + (None,) * len(sds.shape)):
            names = () if part is None else (
                (part,) if isinstance(part, str) else part)
            n *= d // int(np.prod([mesh.shape[a] for a in names]))
        return n

    return jax.tree.leaves(jax.tree.map(local, axes, specs,
                                        is_leaf=_is_axes))


def leaf_paths(tree, path=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k],
                                                            f"{path}/{k}")]
    if isinstance(tree, tuple):
        return [p for i, t in enumerate(tree)
                for p in leaf_paths(t, f"{path}[{i}]")]
    return [path]


def tp_local(cfg, path):
    """The ``TP_LOCAL`` name of an SSD mixer's leaf at ``path``, or None."""
    for i, spec in enumerate(cfg.pattern):
        pre = f"/blocks[{i}]/mixer/"
        if spec.kind == "ssm" and pre in path:
            name = path.split(pre)[1]
            return name if name in TP_LOCAL else None
    return None


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list(REGISTRY))
def test_argument_bytes_follow_the_rules(arch, multi_pod):
    cfg, mesh = get(arch), make_production_mesh(multi_pod)
    got = input_specs(cfg, SHAPES["train_4k"], mesh)
    leaves = tree_leaves(got)
    paths = leaf_paths(got)
    want = reference_bytes(arch, multi_pod)
    assert len(leaves) == len(want) == len(paths)
    plan = train_plan(cfg, mesh)
    dims = tree_leaves({"batch": {k: None for k in got["batch"]},
                        "state": plan.state_dims()})
    whole = tree_leaves({"batch": batch_specs(cfg, SHAPES["train_4k"]),
                         "state": state_specs(cfg)})
    assert len(dims) == len(whole) == len(leaves)
    n, local = mesh.shape["model"], 0
    for t, w, path, d, k in zip(leaves, want, paths, dims,
                                range(len(leaves))):
        b = t.numel() * t.element_size()
        name = tp_local(cfg, path)
        if name is None:
            assert b == w, (path, b, w)
            continue
        # the port's layout: the last dim by TP_LOCAL, the fsdp dim over
        # data as the rules cut it
        full = whole[k]
        shape = list(full.shape)
        shape[-1] = tp_local_width(name, cfg, n)
        if d is not None:
            shape[d] //= mesh.shape["data"]
        assert tuple(t.shape) == tuple(shape), (path, t.shape, shape)
        local += 1
    assert (local > 0) == any(s.kind == "ssm" for s in cfg.pattern)


def test_dryrun_one_cell_on_the_production_mesh():
    """The reference's ``tests/test_system.py::test_dryrun_one_cell_
    compiles_on_production_mesh`` on the port: internvl2-2b ``train_4k``
    on 16x16 (its KV heads, 8, replicated on 16), the shape pass alone;
    its argument bytes are the rules' (the test above)."""
    rec = dryrun.run_cell("internvl2-2b", "train_4k", multi_pod=False,
                          verbose=False, probe=False)
    assert rec["mesh"] == "16x16"
    bpd = rec["bytes_per_device"]
    assert bpd["peak"] > 0
    assert bpd["argument"] == sum(reference_bytes("internvl2-2b", False))


def by_kind(c):
    """A rank's counters (``serve.tp.counters``) by collective kind:
    (count, result bytes)."""
    reduce_ = ("tp_all_reduce", "tp_enter", "tp_norm_dot", "fsdp_sum",
               "tp_sum", "pod_sum")
    gather = ("tp_all_gather", "fsdp_gather")
    return {"all-reduce": (sum(c[k] for k in reduce_),
                           sum(c[f"{k}_bytes"] for k in reduce_)),
            "all-gather": (sum(c[k] for k in gather),
                           sum(c[f"{k}_bytes"] for k in gather))}


def test_a_layout_mesh_records_what_a_real_mesh_runs():
    """One train step of qwen2.5-14b-tiny at 10/2 heads (mid-head columns
    gathered, FSDP over data) on a real CPU 2,2 mesh, and on a 2,2 layout
    on meta: every rank's collectives by kind, count and bytes, equal
    to the layout's records."""
    arch = "qwen2.5-14b"
    ref = reference(arch, steps=1, **QWEN_10_2)
    cfg = get(arch).tiny(**QWEN_10_2)
    with make_mesh_from_devices("2,2", device_type="cpu") as mesh:
        tr = mesh_train(arch, mesh, ref.state0, **QWEN_10_2)
        try:
            tr.sess.run(counters, True)
            tr.state, _ = tr.step(tr.state, ref.batches[0])
            real = tr.sess.run(counters)
        finally:
            tr.close()
    layout = LayoutMesh((2, 2))
    from repro_torch.params import shard_train_state

    state = shard_train_state(state_specs(cfg), cfg, layout)
    batch = {k: torch.empty(v.shape, dtype=torch.int32, device="meta")
             for k, v in ref.batches[0].items()}
    assert batch["tokens"].shape[1:] == (MICRO, SEQ)
    make_train_step(cfg, OptHParams(), layout)(state, batch)
    want = {}
    for kind, _, _, size in layout.records:
        n, b = want.get(kind, (0, 0))
        want[kind] = (n + 1, b + size)
    assert want["all-gather"][0] > 0 and want["all-reduce"][0] > 0
    for c in real:
        assert by_kind(c) == want, (by_kind(c), want)


def test_a_pod_axis_trains_within_the_bars():
    """A real CPU 2,2,1 (pod, data, model) mesh: each rank one row of
    every microbatch of 4, FSDP over data within each pod, every leaf's
    gradient, the loss and the label count summed over pod too; one and
    two steps against the reference's single-device steps."""
    arch = "qwen2.5-14b"
    ref = reference(arch, steps=2)
    with make_mesh_from_devices("2,2,1", device_type="cpu") as mesh:
        assert mesh.shape == {"pod": 2, "data": 2, "model": 1}
        one = ref._replace(batches=ref.batches[:1])
        metrics, leaves, count = run_mesh(arch, mesh, one)
        assert misses(ref, metrics, leaves) == []
        # over pod: the gradients (one all-reduce), the label counts, the
        # loss
        assert all(c["pod_sum"] == 3 and c["fsdp_sum"] > 0 for c in count)
        metrics, leaves, _ = run_mesh(arch, mesh, ref)
        assert misses(ref, metrics, leaves) == []


def test_serving_cells_skip_and_the_out_file_resumes(tmp_path, capsys):
    for shape in ("prefill_32k", "decode_32k"):
        rec = dryrun.run_cell("qwen2.5-14b", shape, multi_pod=True,
                              verbose=False)
        assert rec["mesh"] == "2x16x16" and "item 20b" in rec["skipped"]
    out = tmp_path / "cells.jsonl"
    argv = ["--arch", "mamba2-780m", "--shape", "decode_32k",
            "--both-meshes", "--out", str(out)]
    dryrun.main(argv)
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert all("item 20b" in r["skipped"] for r in recs)
    capsys.readouterr()
    dryrun.main(argv)
    said = capsys.readouterr().out
    assert "skip cached mamba2-780m decode_32k 16x16" in said
    assert "skip cached mamba2-780m decode_32k 2x16x16" in said
    assert len(out.read_text().splitlines()) == 2


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-780m",
                                  "musicgen-large"])
def test_to_shardings_equals_the_reference(arch, multi_pod):
    """``specs.to_shardings`` of the train cell's axes trees (``state_axes``
    and ``batch_axes``) on a production mesh, leaf by leaf, against the
    reference's ``to_shardings`` (its ``NamedSharding``'s spec, padded to
    the leaf's rank) on the stand-in mesh; the decode cache's axes
    (``cache_axes``) equal the reference's too."""
    from repro_torch.launch import specs as pspecs

    cfg, jcfg, shape = get(arch), jget(arch), SHAPES["train_4k"]
    axes = {"state": pspecs.state_axes(cfg), "batch": pspecs.batch_axes(cfg)}
    got = pspecs.to_shardings(axes, {"state": state_specs(cfg),
                                     "batch": batch_specs(cfg, shape)},
                              make_production_mesh(multi_pod))
    jspec, _ = jspecs.input_specs(jcfg, shape, None)
    jaxes = {"state": jspecs.state_axes(jcfg),
             "batch": jspecs.batch_axes(jcfg)}
    want = jax.tree.leaves(
        jspecs.to_shardings(jaxes, jspec, stand_in(multi_pod)),
        is_leaf=lambda x: hasattr(x, "spec"))
    got = _spec_leaves(got)
    assert len(got) == len(want)
    for g, w, leaf in zip(got, want, jax.tree.leaves(jspec)):
        pad = tuple(w.spec) + (None,) * (len(leaf.shape) - len(w.spec))
        assert g == pad, (g, pad)
    dshape = SHAPES["decode_32k"]
    assert _spec_leaves(pspecs.cache_axes(cfg, dshape.batch, dshape.seq)) \
        == _spec_leaves(jspecs.cache_axes(jcfg, dshape.batch, dshape.seq))


def _spec_leaves(tree):
    """The spec (or axes) tuples of a tree, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if all(e is None or isinstance(e, (str, tuple)) for e in tree):
        return [tree]
    return [x for t in tree for x in _spec_leaves(t)]
