"""Mesh-portable checkpoints of the sharded train state, the elastic
restart, the refusals and a failing follower, on the CPU (gloo ranks,
tiny f32 configs; the reference runs and bars of ``tests/fsdp_ref.py``).

  * A checkpoint saved on a 2,1 mesh fed by rank 0's ``UMTPrefetcher``
    (rank 0's UMT tasks write it, each leaf assembled whole from the
    ranks' blocks) loads in the reference's
    ``load_checkpoint`` and on one device, equal to the mesh's state
    byte for byte.
  * A reference checkpoint restores onto 2,1, byte for byte, and three
    steps from it end at the reference's run.
  * Saved on 4,1 after two of four steps, restored onto 2,1 and onto one
    device: each restore equal to the saved state byte for byte, and each
    continuation, like the uninterrupted 4,1 run, ends at the reference's
    four steps by the bars of ``fsdp_ref``.
  * Across 2-D meshes (tensor parallelism in training): mamba2-780m
    saved on 2,2 after two of three steps (each leaf assembled over both
    axes, the SSD mixer's B and C columns once), restored onto 1,2, 2,1
    and one device, each equal to the saved state byte for byte and each
    continuation at the reference's third step; the same checkpoint
    loads in the reference.
  * The elastic restart: data 4 at accum 1, a checkpoint, then data 2
    at accum x ``plan_remesh(...).accum_scale`` (2), which keeps the
    global batch.  Every label kept, so each microbatch's count of
    labelled tokens is the same and the two-microbatch mean equals the
    one-microbatch mean but for f32 rounding: the run ends at the
    reference's uninterrupted data-4 run by the same bars.
  * ``launch.train.build`` on a mesh: rank 0's shard of the seeded state,
    the same loss as on one device.
  * Refusals: SSD head counts a model axis does not divide (item 20b), a
    microbatch the data axis does not divide; a model axis above 1 and
    MoE under a mesh build (items 18b and 9b are done).
  * A follower that raises mid-step fails the step with ``TPError``.
  * ``chip_smoke.fsdp_section`` rehearsed at a tiny config.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tp_faults
from fsdp_ref import (HP, chip_smoke, mesh_train, misses, reference,
                      whole_leaves)
from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro_torch.checkpoint import CheckpointManager, load_checkpoint
from repro_torch.configs import get
from repro_torch.core import UMTRuntime
from repro_torch.data import UMTPrefetcher
from repro_torch.ft import plan_remesh
from repro_torch.launch.mesh import Mesh, make_mesh_from_devices
from repro_torch.launch.train import MeshTrain, build
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import OptHParams
from repro_torch.params import shard_train_state, train_state_from_numpy
from repro_torch.serve.tp import REPLY_S, TPError
from repro_torch.steps import check_train_mesh, make_train_step

ARCH = "qwen2.5-14b"


@pytest.fixture(scope="module")
def mesh2():
    with make_mesh_from_devices("2,1", device_type="cpu") as m:
        yield m


@pytest.fixture(scope="module")
def mesh4():
    with make_mesh_from_devices("4,1", device_type="cpu") as m:
        yield m


def steps_on(tr, batches):
    """``batches`` through a ``MeshTrain``; each step's metrics."""
    out = []
    for b in batches:
        tr.state, m = tr.step(tr.state, b)
        out.append({k: float(v) for k, v in m.items()})
    return out


def same(got, want):
    """Leaf lists equal byte for byte (dtype, shape, values)."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = (torch.as_tensor(np.array(x)) for x in (a, b))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


class Batches:
    """A source of the given batches by step, for ``UMTPrefetcher``."""

    def __init__(self, batches):
        self.batches = batches

    def fetch(self, step):
        return self.batches[step]


def test_a_mesh_checkpoint_loads_in_the_reference_and_on_one_device(
        mesh2, tmp_path):
    """Rank 0 runs the loop on its UMT runtime: the prefetcher feeds the
    mesh's steps, the manager's tasks write the checkpoint."""
    ref = reference(ARCH)
    tr = mesh_train(ARCH, mesh2, ref.state0)
    try:
        with UMTRuntime(n_cores=2) as rt:
            pf = UMTPrefetcher(Batches(ref.batches), rt, depth=2)
            metrics = steps_on(tr, [pf.get(0)])
            mgr = CheckpointManager(str(tmp_path), rt=rt)
            tr.save(mgr, tr.state, 1)
            mgr.wait()
        leaves = whole_leaves(tr)
    finally:
        tr.close()
    assert misses(ref, metrics, leaves) == []
    loaded, step = jload(str(tmp_path), jax.tree.map(jnp.asarray,
                                                     ref.state0))
    assert step == 1
    same(jax.tree.leaves(loaded), leaves)
    cfg = get(ARCH).tiny()
    one, step = load_checkpoint(str(tmp_path),
                                train_state_from_numpy(ref.state0, cfg,
                                                       "cpu"))
    assert step == 1
    same(tree_leaves(one), leaves)


def test_a_reference_checkpoint_restores_onto_a_mesh(mesh2, tmp_path):
    ref = reference(ARCH)
    jsave(jax.tree.map(jnp.asarray, ref.states[0]), 1, str(tmp_path))
    tr = mesh_train(ARCH, mesh2, ref.state0)
    try:
        tr.state, step = tr.restore(str(tmp_path), tr.state)
        assert step == 1
        same(whole_leaves(tr), jax.tree.leaves(ref.states[0]))
        metrics = steps_on(tr, ref.batches[1:])
        leaves = whole_leaves(tr)
    finally:
        tr.close()
    assert misses(ref, metrics, leaves, first=1) == []


def test_save_on_4_restore_on_2_and_on_one_device(mesh2, mesh4, tmp_path):
    ref = reference(ARCH, steps=4)
    mgr = CheckpointManager(str(tmp_path))
    tr = mesh_train(ARCH, mesh4, ref.state0)
    try:
        metrics = steps_on(tr, ref.batches[:2])
        tr.save(mgr, tr.state, 2, wait=True)
        saved = whole_leaves(tr)
        metrics += steps_on(tr, ref.batches[2:])
        assert misses(ref, metrics, whole_leaves(tr)) == []
    finally:
        tr.close()
    tr = mesh_train(ARCH, mesh2, ref.state0)
    try:
        tr.state, step = tr.restore(str(tmp_path), tr.state)
        assert step == 2
        same(whole_leaves(tr), saved)
        metrics = steps_on(tr, ref.batches[2:])
        assert misses(ref, metrics, whole_leaves(tr), first=2) == []
    finally:
        tr.close()
    cfg = get(ARCH).tiny()
    state, step = mgr.restore(train_state_from_numpy(ref.state0, cfg,
                                                     "cpu"))
    assert step == 2
    same(tree_leaves(state), saved)
    train = make_train_step(cfg, OptHParams(**HP))
    metrics = []
    for b in ref.batches[2:]:
        state, m = train(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    assert misses(ref, metrics, tree_leaves(state), first=2) == []


ARCH_2D = "mamba2-780m"


@pytest.fixture(scope="module")
def saved_2_2(tmp_path_factory):
    """Two of three reference steps of ``ARCH_2D`` on a 2,2 mesh, saved:
    (the checkpoint's directory, the saved state's whole leaves)."""
    ref = reference(ARCH_2D)
    path = tmp_path_factory.mktemp("ckpt_2_2")
    with make_mesh_from_devices("2,2", device_type="cpu") as mesh:
        tr = mesh_train(ARCH_2D, mesh, ref.state0)
        try:
            metrics = steps_on(tr, ref.batches[:2])
            tr.save(CheckpointManager(str(path)), tr.state, 2, wait=True)
            saved = whole_leaves(tr)
        finally:
            tr.close()
    assert misses(ref, metrics, saved) == []
    return path, saved


@pytest.fixture(scope="module")
def mesh12():
    with make_mesh_from_devices("1,2", device_type="cpu") as m:
        yield m


@pytest.mark.parametrize("target", ["1,2", "2,1", "one device",
                                    "reference"])
def test_a_2_2_checkpoint_restores_onto_any_mesh(target, saved_2_2, mesh2,
                                                 mesh12):
    path, saved = saved_2_2
    ref = reference(ARCH_2D)
    if target == "reference":
        loaded, step = jload(str(path), jax.tree.map(jnp.asarray,
                                                     ref.state0))
        assert step == 2
        same(jax.tree.leaves(loaded), saved)
        return
    if target == "one device":
        cfg = get(ARCH_2D).tiny()
        state, step = load_checkpoint(str(path), train_state_from_numpy(
            ref.state0, cfg, "cpu"))
        assert step == 2
        same(tree_leaves(state), saved)
        train = make_train_step(cfg, OptHParams(**HP))
        state, m = train(state, ref.batches[2])
        metrics, leaves = [{k: float(v) for k, v in m.items()}], \
            tree_leaves(state)
    else:
        tr = mesh_train(ARCH_2D, {"1,2": mesh12, "2,1": mesh2}[target],
                        ref.state0)
        try:
            tr.state, step = tr.restore(str(path), tr.state)
            assert step == 2
            same(whole_leaves(tr), saved)
            metrics = steps_on(tr, ref.batches[2:])
            leaves = whole_leaves(tr)
        finally:
            tr.close()
    assert misses(ref, metrics, leaves, first=2) == []


def test_elastic_restart_from_data_4_to_data_2(mesh2, mesh4, tmp_path):
    ref = reference(ARCH, micro=4, accum=1, steps=4, masked=False)
    plan = plan_remesh(2, chips_per_host=1, old_mesh=(4, 1),
                       axis_names=("data", "model"), global_batch=4,
                       micro_batch=1)
    assert plan.new_mesh == (2, 1) and plan.accum_scale == 2
    tr = mesh_train(ARCH, mesh4, ref.state0)
    try:
        steps_on(tr, ref.batches[:2])
        tr.save(CheckpointManager(str(tmp_path)), tr.state, 2, wait=True)
    finally:
        tr.close()
    accum = 1 * plan.accum_scale
    regrouped = [{k: v.reshape((accum, v.shape[1] // accum) + v.shape[2:])
                  for k, v in b.items()} for b in ref.batches[2:]]
    tr = mesh_train(ARCH, mesh2, ref.state0)
    try:
        _, step = tr.restore(str(tmp_path), tr.state)
        assert step == 2
        metrics = steps_on(tr, regrouped)
        assert misses(ref, metrics, whole_leaves(tr), first=2) == []
    finally:
        tr.close()


def test_build_on_a_mesh_drives_the_ranks(mesh2):
    """``launch.train.build(cfg, hp, device, mesh=)``, the reference's
    ``build(cfg, mesh, hp)``: rank 0's shard of the same seeded state as
    the single-device ``build``, and a step of the same loss."""
    cfg = get(ARCH).tiny()
    hp = OptHParams(**HP)
    step1, state1 = build(cfg, hp, "cpu")
    step2, state2 = build(cfg, hp, "cpu", mesh=mesh2)
    try:
        assert isinstance(step2.__self__, MeshTrain)
        same(tree_leaves(state2), tree_leaves(
            shard_train_state(state1, cfg, mesh2)))
        b = reference(ARCH).batches[0]
        _, m1 = step1(state1, b)
        _, m2 = step2(state2, b)
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=1e-5)
    finally:
        step2.__self__.close()


def test_what_is_not_ported_raises():
    # MoE under a mesh is ported: mixtral's step builds on 2,1 and rank
    # 0's shard holds every expert at half its d_model rows
    # (tests/test_torch_moe_mesh.py trains it)
    moe_cfg = get("mixtral-8x7b").tiny()
    mesh21 = Mesh({"data": 2, "model": 1})
    check_train_mesh(moe_cfg, mesh21)
    assert callable(make_train_step(moe_cfg, OptHParams(), mesh21))
    moe_ref = reference("mixtral-8x7b")
    moe_part = shard_train_state(train_state_from_numpy(
        moe_ref.state0, moe_cfg, "cpu"), moe_cfg, mesh21)["params"]
    assert moe_part["blocks"][0]["mlp"]["w_gate"].shape == (
        moe_cfg.n_repeats, moe_cfg.n_experts, moe_cfg.d_model // 2,
        moe_cfg.d_ff)
    # a model axis above 1 trains (item 18b): the step builds on a 2,2
    # mesh and the state is cut on 1,2 (rank 0's view, no processes;
    # tests/test_torch_tp_train.py runs the steps)
    cfg = get(ARCH).tiny()
    ref = reference(ARCH)
    assert callable(make_train_step(cfg, OptHParams(),
                                    Mesh({"data": 2, "model": 2})))
    whole = train_state_from_numpy(ref.state0, cfg, "cpu")
    part = shard_train_state(whole, cfg, Mesh({"data": 1, "model": 2}))
    assert part["params"]["lm_head"].shape == (cfg.d_model, cfg.vocab // 2)
    assert part["opt"]["m"]["blocks"][0]["mixer"]["wq"].shape == (
        cfg.n_repeats, cfg.d_model, cfg.n_heads * cfg.head_dim // 2)
    assert torch.equal(part["params"]["final_norm"],
                       whole["params"]["final_norm"])
    # attention head counts the model axis does not divide train, whole
    # on every rank (item 20); SSD head counts it does not divide
    # (mamba2-780m-tiny's 8 at model 3) raise (item 20b)
    assert callable(make_train_step(cfg, OptHParams(),
                                    Mesh({"data": 1, "model": 3})))
    with pytest.raises(NotImplementedError, match="item 20b"):
        make_train_step(get("mamba2-780m").tiny(), OptHParams(),
                        Mesh({"data": 1, "model": 3}))
    # a microbatch of 3 rows on data 2: the step raises before any
    # collective (rank 0's view of a mesh, no processes)
    mesh = Mesh({"data": 2, "model": 1})
    state = train_state_from_numpy(ref.state0, cfg, "cpu", mesh)
    odd = {k: v[:, :3] for k, v in ref.batches[0].items()}
    with pytest.raises(NotImplementedError, match="does not split 2 ways"):
        make_train_step(cfg, OptHParams(**HP), mesh)(state, odd)


def test_a_follower_that_raises_fails_the_step():
    """Rank 1 raises in its MLP mid-step: rank 0's step fails with
    ``TPError`` naming it, well within ``REPLY_S``, and the followers
    are torn down."""
    ref = reference(ARCH)
    mesh = make_mesh_from_devices("2,1", device_type="cpu")
    try:
        tr = mesh_train(ARCH, mesh, ref.state0)
        assert tr.sess.run(tp_faults.mlp_raises_on_rank, 1, 1) == [0, 1]
        t0 = time.monotonic()
        with pytest.raises(TPError, match="planted fault on rank 1"):
            tr.step(tr.state, ref.batches[0])
        assert time.monotonic() - t0 < REPLY_S / 4
        assert mesh.closed
        with pytest.raises(TPError, match="failed earlier"):
            tr.step(tr.state, ref.batches[0])
    finally:
        mesh.close()


def test_chip_smoke_fsdp_section_rehearses_on_the_cpu():
    """``chip_smoke.fsdp_section`` on the CPU (``device="cpu"``: tiny
    configs): its legs, bars, planted faults and counts run to the end."""
    launches = chip_smoke.fsdp_section("cpu", device="cpu")
    assert set(launches) >= {"rms_norm", "rms_norm_bwd", "ssd_scan",
                             "ssd_scan_bwd"}
