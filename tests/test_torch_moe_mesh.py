"""MoE layers under a mesh on the port (``models.moe`` on ``D,M`` meshes),
on the CPU: each mesh is rank 0 (this process) and follower processes on
gloo, tiny f32 configs (4 experts, d_ff 128, 4 heads), weights and train
states carried over from the reference's ``init_params`` /
``init_train_state`` as numpy.

  * Serving (``ServeEngine(..., mesh=)``, the reference's leg geometry
    of ``tests/test_torch_tp.py``): mixtral-8x7b at model 2 and 4 with
    the capacity and the dropless dispatch, jamba-v0.1-52b (one block of
    8 layers, dropless) and grok-1-314b at model 2.  Every request's
    greedy tokens equal the reference's single-device
    ``repro.steps.greedy_oneshot`` rows and the port's single-device
    engine's, exactly.
  * mixtral's sliding-window rings under TP: a window of 8 that prompts
    of 12 to 23 tokens pass, each rank rolling the ring of its KV heads;
    the TP engine's tokens equal the single-device engine's and the
    train forward's argmax.
  * The footprint of a decode tick: per-rank expert bytes by rule (every
    expert at half its d_ff columns, the router whole), the collectives
    by formula (a MoE layer takes one all-reduce, as a dense MLP), the
    same expert ids on every rank by digest.
  * Training (``MeshTrain``) against the reference's single-device step
    over two steps by ``tests/fsdp_ref.py``'s bars: mixtral at 2,1, 1,2
    and 2,2, jamba at 2,2.  The load-balance term is in the
    loss.  AdamW's moments are f32 here: the registry stores mixtral's
    and jamba's in bf16, whose rounding (2^-9) moves a parameter by up to
    about 3e-6 in two steps, past the bars, in the port's single-device
    run as much as on a mesh.  jamba runs its tiny two blocks (16
    layers), each step from the reference's state before it, here and on
    one device: straight through two steps, step 1 leaves apart 42
    elements whose gradient lay under ``fsdp_ref.SENSITIVE`` (by up to
    3.0e-5, within their 2 lr), and through the second step's forward
    they move 20 param leaves by up to 2.7e-6 and one v leaf by 1.3e-4
    relative, past the bars, on one device as on a mesh; from the
    reference's state the port's step 2 meets every bar and routes every
    token as the reference does (``tests/jamba_drift.py``).
  * Planted faults, each failing its bar in f32 by more than ten times
    it: the rank's partial MoE output added unsummed and each rank's
    ``w_gate`` columns taken from the next rank's (served prefill logits
    against single-device, bar 1e-5 of their largest magnitude); the
    combine weights not entering this rank's columns, each data rank's
    own load-balance term and the term's data sum with a summing
    backward (the reference's bars; and the router's m after one step,
    by its relative L2 error against the bar 1e-4).
  * ``chip_smoke.tp_leg``'s mixtral-8x7b leg rehearsed at the tiny
    config (the TP train section's mixtral leg rehearses in
    ``tests/test_torch_tp_train.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fsdp_ref import HP, chip_smoke, misses, reference, run_mesh
from repro_torch.configs import get
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.layers import tree_leaves
from repro_torch.models.lm import LeafMeta, forward, init_params, param_meta
from repro_torch.optim import OptHParams
from repro_torch.params import train_state_from_numpy
from repro_torch.serve import Request, ServeEngine, drain
from repro_torch.serve.tp import Session, counters, tree_bytes
from repro_torch.steps import make_prefill_step, make_train_step
from test_torch_tp import CACHE_LEN, DRAIN_S, GEN_MAX, build, run_leg

F32_OPT = dict(opt_dtype="float32")
EXPERTS = ("w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def mesh12():
    with make_mesh_from_devices("1,2", device_type="cpu") as m:
        yield m


@pytest.fixture(scope="module")
def mesh14():
    with make_mesh_from_devices("1,4", device_type="cpu") as m:
        yield m


@pytest.fixture(scope="module")
def mesh21():
    with make_mesh_from_devices("2,1", device_type="cpu") as m:
        yield m


@pytest.fixture(scope="module")
def mesh22():
    with make_mesh_from_devices("2,2", device_type="cpu") as m:
        yield m


# ----------------------------------------------------------------- serving
SERVE_CASES = [("mixtral-8x7b", "onehot", 2), ("mixtral-8x7b", "ragged", 2),
               ("mixtral-8x7b", "onehot", 4), ("mixtral-8x7b", "ragged", 4),
               ("jamba-v0.1-52b", "ragged", 2), ("grok-1-314b", "onehot", 2)]


def over(arch, impl):
    """The tiny config's overrides: the dispatch, jamba at one block."""
    return dict(moe_impl=impl, **({"n_layers": 8}
                                  if arch == "jamba-v0.1-52b" else {}))


@pytest.mark.parametrize("arch,impl,model", SERVE_CASES)
def test_moe_serving_equals_the_single_device_rows(arch, impl, model,
                                                   mesh12, mesh14):
    """Two legs of the reference's geometry (seeded budgets and arrival
    order, 3 slots, paged): donated with the reserve policy, and not
    donated through the paged kernel's plain version; the dropless legs
    also on demand (a restore replays through the dropless prefill; the
    capacity dispatch would drop other picks over prompt + tokens)."""
    cfg, params, prompts, ref = build(arch, **over(arch, impl))
    mesh = {2: mesh12, 4: mesh14}[model]
    legs = [dict(seed=0, donate=True, policy="reserve"),
            dict(seed=1, donate=False, paged_kernel=True)]
    if impl == "ragged":
        legs.append(dict(seed=2, policy="ondemand"))
    for leg in legs:
        kw = dict(leg)
        seed = kw.pop("seed")
        single, _ = run_leg(cfg, params, prompts, None, seed, **kw)
        got, stats = run_leg(cfg, params, prompts, mesh, seed, **kw)
        for rid, toks in got.items():
            assert np.array_equal(toks, ref[rid, :len(toks)]), (leg, rid)
            assert np.array_equal(toks, single[rid]), (leg, rid)
        if kw.get("policy") == "ondemand":
            assert stats["restores"] == stats["evictions"]


RING = 8


def _serve(cfg, params, prompts, mesh, gen):
    eng = ServeEngine(cfg, params, slots=3, cache_len=32, mesh=mesh,
                      page_size=8, n_cores=4, device="cpu").start()
    reqs = [Request(i, p, max_new_tokens=gen) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    drain(eng, reqs, DRAIN_S)
    return [np.asarray(r.wait(), np.int32) for r in reqs]


def test_rings_roll_on_every_rank(mesh12):
    """mixtral's window cut to 8, the dropless dispatch: prompts of 5 to
    23 tokens (12, 19 and 23 past the window and no multiple of it), 6
    tokens each, on two ranks (each its 2 of 4 KV heads' rings) against
    one device, and each emitted token the argmax of the train forward
    (full attention under the true window mask) over prompt + tokens."""
    base = get("mixtral-8x7b").tiny()
    cfg = base.replace(moe_impl="ragged", pattern=(dataclasses.replace(
        base.pattern[0], window=RING),))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 12, 19, 16, 23, 9)]
    single = _serve(cfg, params, prompts, None, 6)
    tp = _serve(cfg, params, prompts, mesh12, 6)
    for p, a, b in zip(prompts, single, tp):
        assert np.array_equal(a, b)
        seq = torch.tensor(np.concatenate([p, a[:-1]])[None])
        lg = forward(params, cfg, seq, mode="train")["logits"][0]
        assert np.array_equal(lg[len(p) - 1:].argmax(-1).numpy(), a)


def test_decode_tick_footprint_collectives_and_expert_ids(mesh12):
    """One decode tick dispatched by hand on an engine that is not
    started (``tests/test_torch_tp.py``'s footprint test): each rank's
    ``w_gate``, ``w_up`` and ``w_down`` half of one device's, the router
    whole; 2 all-reduces a layer (the attention's output, the MoE's
    partial ``y`` after the sum over picks) + the embedding's, one
    all-gather; the prefill's and the tick's expert ids the same on both
    ranks (``chip_smoke.tp_routes_on`` / ``tp_routes_off`` digests)."""
    cfg, params, prompts, _ = build("mixtral-8x7b", moe_impl="ragged")
    eng = ServeEngine(cfg, params, slots=3, cache_len=CACHE_LEN,
                      mesh=mesh12, page_size=7, n_cores=4, device="cpu")
    try:
        sess, kv = eng._tp, eng.kv
        held = sess.run(tree_bytes, sess.params)
        n_moe = 0
        for i, blk in enumerate(param_meta(cfg)["blocks"]):
            for k, m in blk["mlp"].items():
                full = int(np.prod(m.shape)) * 4
                for rank in held:
                    got = rank[f"/blocks[{i}]/mlp/{k}"][0]
                    assert got * (2 if k in EXPERTS else 1) == full, k
                n_moe += k in EXPERTS
        assert n_moe == 3
        sess.run(chip_smoke.tp_routes_on)
        sess.run(counters, True)
        prefill = sess.step("p", make_prefill_step, cache_len=CACHE_LEN)
        prefill(sess.params, torch.tensor(prompts[:2]))
        args = (eng._params, kv.cache, eng._tokens, eng._active_dev,
                kv.table_dev)
        _, new_cache = eng.decode(*args)
        kv.commit(new_cache)
        got = sess.run(counters)
        ids = sess.run(chip_smoke.tp_routes_off)
        sess.local.extra.pop("routes")
        # two passes (the prefill, the tick), each routing every layer
        assert ids[0][0] == 2 * cfg.n_layers and ids[1] == ids[0], ids
        for c in got:
            assert c["tp_all_reduce"] == 2 * (2 * cfg.n_layers + 1), c
            assert c["tp_all_gather"] == 2, c
    finally:
        eng.shutdown()


@pytest.mark.parametrize("fault", ["moe_all_reduce_left_out",
                                   "moe_ff_next_rank"])
def test_served_faults_fail_the_logit_bar(fault, mesh12):
    """Prefill logits through a Session against one device's, as built
    within 1e-5 of their largest magnitude (``tests/test_torch_tp.py``'s
    bar: partials summed in another order), and under each planted fault
    (on every rank) off by more than ten times that."""
    cfg, params, prompts, _ = build("mixtral-8x7b")
    tok = torch.tensor(prompts)
    _, want = make_prefill_step(cfg, cache_len=CACHE_LEN)(params, tok)
    bar = 1e-5 * want.abs().max().item()
    sess = Session(mesh12, cfg, "cpu")
    try:
        sp = sess.load(params)
        prefill = sess.step("prefill", make_prefill_step,
                            cache_len=CACHE_LEN)
        _, got = prefill(sp, tok)
        assert (got - want).abs().max().item() <= bar
        sess.run(chip_smoke.tp_fault_on, fault)
        _, bad = prefill(sp, tok)
        sess.run(chip_smoke.tp_fault_off, fault)
        err = (bad - want).abs().max().item()
        print(f"{fault}: prefill logits off by {err:.3e}, {err / bar:.1f} "
              f"x the bar {bar:.3e}")
        assert err > 10 * bar, (fault, err / bar)
        _, again = prefill(sp, tok)         # the fault lifted
        assert torch.equal(again, got)
    finally:
        sess.close()


# ---------------------------------------------------------------- training
TRAIN_CASES = [("mixtral-8x7b", "2,1"), ("mixtral-8x7b", "1,2"),
               ("mixtral-8x7b", "2,2"), ("jamba-v0.1-52b", "2,2")]


# jamba trains at its tiny two blocks (16 layers), each step from the
# reference's state before it: straight through two steps, the elements
# step 1 may leave apart (AdamW's sensitive ones) move step 2's gradients
# past the bars, on one device as on a mesh (``tests/jamba_drift.py``)
STEPWISE = ("jamba-v0.1-52b",)


def stepwise(ref):
    """``ref``'s steps one at a time, each from the reference's state
    before it: (the step's index, the run ``run_mesh`` takes) pairs."""
    return [(k, ref._replace(state0=ref.states[k - 1] if k else ref.state0,
                             batches=ref.batches[k:k + 1]))
            for k in range(len(ref.batches))]


@pytest.mark.parametrize("arch,spec", TRAIN_CASES)
def test_moe_training_matches_the_reference(arch, spec, mesh12, mesh21,
                                            mesh22):
    mesh = {"1,2": mesh12, "2,1": mesh21, "2,2": mesh22}[spec]
    ref = reference(arch, steps=2, **F32_OPT)
    runs = stepwise(ref) if arch in STEPWISE else [(0, ref)]
    for first, run in runs:
        metrics, leaves, count = run_mesh(arch, mesh, run, **F32_OPT)
        assert misses(ref, metrics, leaves, first) == [], first
        # the load-balance term's means crossed the data axis: once a MoE
        # layer and microbatch (remat "none" at the tiny config)
        if mesh.shape["data"] > 1:
            assert all(c["fsdp_sum"] > 4 for c in count)


def test_jamba_two_blocks_train_steps_match_the_reference_on_one_device():
    """jamba's tiny two blocks on one device, each of two steps from the
    reference's state before it, by the same bars: the single-device
    comparison whose second step drifted straight through
    (``tests/jamba_drift.py``)."""
    arch = "jamba-v0.1-52b"
    ref = reference(arch, steps=2, **F32_OPT)
    cfg = get(arch).tiny(**F32_OPT)
    assert cfg.n_layers == 16
    step = make_train_step(cfg, OptHParams(**HP))
    for first, run in stepwise(ref):
        state, m = step(train_state_from_numpy(run.state0, cfg, "cpu"),
                        run.batches[0])
        leaves = ([x.detach() for k in ("m", "v")
                   for x in tree_leaves(state["opt"][k])]
                  + [x.detach() for x in tree_leaves(state["params"])]
                  + [state["step"]])
        assert misses(ref, [{k: float(v) for k, v in m.items()}], leaves,
                      first) == [], first


ROUTER_BAR = 1e-4       # fsdp_ref's bound on m's relative L2 error


@pytest.mark.parametrize("fault", chip_smoke.MOE_TRAIN_FAULTS)
def test_planted_train_faults_fail_the_bars(fault, mesh22):
    """mixtral on 2,2, one step: each fault misses the reference's bars,
    and moves the router's m (``(1 - b1)`` times its clipped gradient)
    by more than ten times m's bar."""
    arch = "mixtral-8x7b"
    ref = reference(arch, steps=1, **F32_OPT)
    metrics, leaves, _ = run_mesh(arch, mesh22, ref, fault=fault,
                                  **F32_OPT)
    assert misses(ref, metrics, leaves), fault
    paths = [p for p in _leaf_paths(param_meta(get(arch).tiny()))]
    k = paths.index("/blocks[0]/mlp/router")
    want = np.asarray(jax.tree.leaves(ref.states[0])[k], np.float32)
    rel = np.linalg.norm(leaves[k].float().numpy() - want) / \
        np.linalg.norm(want)
    print(f"{fault}: {len(misses(ref, metrics, leaves))} bars missed; the "
          f"router's m off by {rel:.3e} relative, {rel / ROUTER_BAR:.0f} x "
          f"its bar {ROUTER_BAR}")
    assert rel > 10 * ROUTER_BAR, (fault, rel)


def _leaf_paths(tree, path=""):
    """Leaf paths in ``tree_leaves`` order (sorted dict keys)."""
    if isinstance(tree, LeafMeta):
        return [path]
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _leaf_paths(tree[k],
                                                             f"{path}/{k}")]
    if isinstance(tree, tuple):
        return [q for i, t in enumerate(tree)
                for q in _leaf_paths(t, f"{path}[{i}]")]
    return [path]


# -------------------------------------------------------------- rehearsal
def test_chip_smoke_mixtral_tp_leg_rehearses_on_the_cpu(mesh12):
    """``chip_smoke.tp_leg``'s mixtral-8x7b leg on the CPU (its tiny
    config, ``TP_CPU_TRAFFIC``, the window cut to 16): the engine on both
    ranks, pool and expert bytes, collectives, the expert ids' digests,
    the route check and the logit checks run to the planted faults'
    verdict.  At d 64 the MoE's output is a small part of the residual
    stream, so its two faults stay under the relative bar (0.14 and 0.29
    against 0.3) and no logit spread reaches the token bar: the leg ends
    in that verdict, naming both (on the card, at d 4096, they show)."""
    with pytest.raises(AssertionError) as err:
        chip_smoke.tp_leg(mesh12, "mixtral-8x7b", "cpu", "cpu")
    assert str(err.value).endswith(
        "do not reject the planted TP faults ['moe_all_reduce_left_out', "
        "'moe_ff_next_rank']"), err.value
