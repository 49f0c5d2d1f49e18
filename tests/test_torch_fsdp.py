"""The sharded train state on the port (FSDP over the mesh's ``data``
axis: ``steps.make_train_step(cfg, hp, mesh=)`` driven by
``launch.train.MeshTrain``), on the CPU: each mesh is rank 0 (this
process) and follower processes on gloo, tiny f32 configs, the state
carried over from the reference's ``init_train_state`` as numpy.

  * Against the reference: three port steps on meshes 2,1 and 4,1 from
    the reference's state, on its batches with labels of -1 spread
    unevenly over the ranks, against the reference's single-device
    ``jax.jit(make_train_step(cfg, None, hp))``, for qwen2.5-14b,
    minicpm3-4b, mamba2-780m, internvl2-2b (the patches ride the batch
    rows) and musicgen-large (a label per codebook), by the bars of
    ``tests/fsdp_ref.py`` (``tests/test_torch_train.py``'s, over three
    steps).
  * A 3,1 mesh at d_model 64, which 3 does not divide: every "fsdp" dim
    stays whole (the reference's strict rule), so the step is plain
    data parallelism, held to the same bars.
  * Per-rank bytes of params, m and v: exactly 1/data for every split
    leaf, whole leaves listed; gathers and reductions per step by their
    formula.
  * Three planted faults fail the bars: the gather's backward keeping
    this rank's gradient unsummed, the blocks gathered in reversed rank
    order, the clip norm taken from the rank's own shards.

The reference's own sharded step does not run on this jax (ROADMAP
queue 3: ``ShardingTypeError`` in ``embed_tokens``), so the oracle is its
single-device step.  Checkpoints across meshes, the elastic restart,
the refusals and a failing follower: ``tests/test_torch_fsdp_checkpoint.py``.
"""
import pytest

from fsdp_ref import ACCUM, mesh_train, misses, reference, run_mesh
from repro_torch.configs import get
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.layers import tree_leaves
from repro_torch.models.lm import LeafMeta, param_meta
from repro_torch.params import train_state_from_numpy
from repro_torch.serve.tp import counters, tree_bytes
from repro_torch.steps import train_plan

ARCHS = ["qwen2.5-14b", "minicpm3-4b", "mamba2-780m", "internvl2-2b",
         "musicgen-large"]


@pytest.fixture(scope="module")
def mesh2():
    with make_mesh_from_devices("2,1", device_type="cpu") as m:
        yield m


@pytest.fixture(scope="module")
def mesh4():
    with make_mesh_from_devices("4,1", device_type="cpu") as m:
        yield m


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("data", [2, 4])
def test_sharded_steps_match_the_reference(arch, data, mesh2, mesh4):
    ref = reference(arch)
    metrics, leaves, _ = run_mesh(arch, {2: mesh2, 4: mesh4}[data], ref)
    assert misses(ref, metrics, leaves) == []


def test_a_width_three_does_not_divide_stays_whole():
    """At d_model 64 on a 3,1 mesh every ``"fsdp"`` dim stays whole, as
    the reference's strict rule leaves it: no gather, only the four sums
    (whole leaves' gradients, the label counts, the loss, the norm's
    squares)."""
    ref = reference("qwen2.5-14b", micro=6)
    with make_mesh_from_devices("3,1", device_type="cpu") as mesh3:
        plan = train_plan(get("qwen2.5-14b").tiny(), mesh3)
        assert all(d is None for d in tree_leaves(plan.dims))
        metrics, leaves, count = run_mesh("qwen2.5-14b", mesh3, ref)
    assert misses(ref, metrics, leaves) == []
    for c in count:
        assert c["fsdp_gather"] == 0 and c["fsdp_sum"] == 4, c


def split_leaves(cfg, mesh):
    """(path, dim) of every split parameter leaf, and the paths of the
    whole ones, in ``tree_leaves`` order."""
    names = []

    def walk(t, path):
        if isinstance(t, LeafMeta):
            names.append(path)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        else:
            for i, x in enumerate(t):
                walk(x, f"{path}[{i}]")
    walk(param_meta(cfg), "")
    dims = tree_leaves(train_plan(cfg, mesh).dims)
    return ([(n, d) for n, d in zip(names, dims) if d is not None],
            [n for n, d in zip(names, dims) if d is None])


@pytest.mark.parametrize("data,remat", [(2, "full"), (4, "none")])
def test_each_rank_holds_its_share_and_collectives_follow_the_formula(
        data, remat, mesh2, mesh4):
    """Params, m and v: every split leaf exactly 1/data of its bytes on
    every rank, every whole leaf (norm weights, biases) whole.  Per step
    and rank: each repeat's split leaves gathered once a microbatch, and
    under remat "full" once more by the backward's recompute, and their
    gradients summed once; the embedding and the head once each; plus
    four sums (whole leaves' gradients, the label counts, the loss, the
    norm's squares)."""
    mesh = {2: mesh2, 4: mesh4}[data]
    arch = "qwen2.5-14b"
    cfg = get(arch).tiny(remat=remat)
    split, whole = split_leaves(cfg, mesh)
    assert {n.rsplit("/", 1)[-1] for n in whole} == {
        "ln", "bq", "bk", "bv", "final_norm"}, whole
    ref = reference(arch)
    whole_bytes = {p: b for p, (b, _) in tree_bytes(
        None, train_state_from_numpy(ref.state0, cfg, "cpu")).items()}
    tr = mesh_train(arch, mesh, ref.state0, remat=remat)
    try:
        per_rank = tr.sess.run(tree_bytes, tr.state)
        tr.sess.run(counters, True)
        tr.state, _ = tr.step(tr.state, ref.batches[0])
        count = tr.sess.run(counters)
    finally:
        tr.close()
    split_names = {n for n, _ in split}
    for held in per_rank:
        assert held.keys() == whole_bytes.keys()
        for path, b in whole_bytes.items():
            leaf = next((path[len(pre):] for pre in ("/params", "/opt/m",
                                                     "/opt/v")
                         if path.startswith(pre)), path)
            share = data if leaf in split_names else 1
            assert held[path][0] * share == b, (path, held[path][0], b)
    # a stacked leaf is gathered once per repeat
    in_blocks = cfg.n_repeats * sum(n.startswith("/blocks")
                                    for n, _ in split)
    outside = sum(not n.startswith("/blocks") for n, _ in split)
    gathers = ACCUM * ((2 if remat == "full" else 1) * in_blocks + outside)
    sums = ACCUM * (in_blocks + outside) + 4
    for c in count:
        assert c["fsdp_gather"] == gathers, (c, gathers)
        assert c["fsdp_sum"] == sums, (c, sums)


@pytest.mark.parametrize("fault", ["sum_dropped", "blocks_reversed",
                                   "clip_norm_local"])
def test_planted_faults_fail_the_bars(fault, mesh2):
    ref = reference("qwen2.5-14b")
    metrics, leaves, _ = run_mesh("qwen2.5-14b", mesh2, ref, fault=fault)
    assert misses(ref, metrics, leaves), fault
