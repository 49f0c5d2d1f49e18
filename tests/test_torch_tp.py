"""Tensor-parallel serving on the port (``ServeEngine(..., mesh=)``), on
the CPU: each mesh is rank 0 (this process) and follower processes on the
gloo backend (``repro_torch.launch.mesh``), tiny f32 configs, weights
carried over from the reference's ``init_params`` as numpy.

  * The reference's TP grid (``tests/test_serve_tp.py:77-123``):
    qwen2.5-14b and minicpm3-4b at model 2 and 4, donate x {reserve,
    ondemand}, chunked prefill on some legs, qwen's paged-kernel leg (its
    plain version here), mamba2-780m dense with reserve.  Every request's
    greedy tokens equal the reference's single-device
    ``repro.steps.greedy_oneshot`` rows and the port's single-device
    engine's, exactly.  The reference's own TP tests fail (ROADMAP
    queue 3); they are not the oracle here.
  * A GQA group above 1 split across ranks (``n_kv_heads=2`` at model 2),
    the prefix cache and speculative decoding under TP, each against the
    port's single-device engine.
  * The systems invariants: per-rank pool bytes (K/V and the SSM state at
    1/2, the conv tail at the port's stated figure, MLA latents and
    positions whole), the block table handed whole to every rank, the
    collectives of a decode tick by their formula, and every pool
    tensor updated in place on every rank.
  * Sharded logits against single-device ones, within a stated f32
    tolerance.
  * Errors, not hangs: a follower that raises fails the live requests
    within the deadline; a non-dividing SSD head count and, in serving, a
    data axis above 1 raise; a non-dividing attention head count and MoE
    build (``tests/test_torch_tp_heads.py`` and
    ``tests/test_torch_moe_mesh.py`` serve them).
  * The CLI: ``--mesh 1,2`` prints the same ``sample`` as ``--mesh 1,1``.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tp_faults
from repro.configs import get as jget
from repro.models.lm import init_params as jax_init_params
from repro_torch.configs import get
from repro_torch.launch.mesh import Mesh, make_mesh_from_devices
from repro_torch.params import params_from_numpy, shard_params
from repro_torch.serve import KVState, Request, ServeEngine, drain
from repro_torch.serve.tp import (Session, TPError, counters, seen,
                                  tree_bytes)
from repro_torch.steps import (greedy_oneshot, make_prefill_step,
                               make_serve_step)

ROOT = Path(__file__).resolve().parents[1]
# the reference test's geometry (tests/test_serve_tp.py)
N_REQ, PLEN, GEN_MAX, CACHE_LEN, PAGE = 6, 8, 6, 14, 7
DRAIN_S = 60


@pytest.fixture(scope="module")
def mesh2():
    with make_mesh_from_devices("1,2", device_type="cpu") as m:
        yield m


@pytest.fixture(scope="module")
def mesh4():
    with make_mesh_from_devices("1,4", device_type="cpu") as m:
        yield m


_BUILT = {}


def build(arch, **over):
    """cfg, port params (full, CPU f32), prompts, the reference's
    single-device one-shot rows (``repro.steps.greedy_oneshot``)."""
    key = (arch, tuple(sorted(over.items())))
    if key in _BUILT:
        return _BUILT[key]
    from repro.serve import make_jit_steps
    from repro.steps import greedy_oneshot as jgreedy
    from repro.steps import make_serve_step as jserve

    jcfg, cfg = jget(arch).tiny(**over), get(arch).tiny(**over)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (N_REQ, PLEN), 0, cfg.vocab), np.int32)
    page = None if arch == "mamba2-780m" else PAGE
    steps = make_jit_steps(jcfg, cache_len=CACHE_LEN, page_size=page)
    ref = np.asarray(jgreedy(steps["prefill"], jax.jit(jserve(jcfg)), jp,
                             jnp.asarray(prompts), None, GEN_MAX))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    _BUILT[key] = (cfg, params, prompts, ref)
    return _BUILT[key]


def run_leg(cfg, params, prompts, mesh, seed, **kw):
    """The reference's ``run_leg``: seeded budgets and arrival order,
    3 slots, drained under a deadline; each request's tokens."""
    rng = np.random.default_rng(seed)
    gens = rng.integers(1, GEN_MAX + 1, N_REQ)
    order = rng.permutation(N_REQ)
    reqs = [Request(int(i), prompts[i], max_new_tokens=int(gens[i]))
            for i in order]
    kw.setdefault("page_size", PAGE)
    eng = ServeEngine(cfg, params, slots=3, cache_len=CACHE_LEN, mesh=mesh,
                      umt=True, n_cores=4, device="cpu", **kw).start()
    assert eng.tp == (mesh is not None and mesh.shape["model"] > 1)
    for r in reqs:
        eng.submit(r)
    stats = drain(eng, reqs, DRAIN_S)
    assert stats["tp"] is eng.tp
    return {r.rid: np.asarray(r.wait(), np.int32) for r in reqs}, stats


def check_grid(arch, mesh):
    cfg, params, prompts, ref = build(arch)
    legs = []
    if arch == "mamba2-780m":
        legs = [dict(seed=0, donate=True, page_size=None),
                dict(seed=1, donate=False, page_size=None)]
    else:
        for donate in (True, False):
            for k, policy in enumerate(("reserve", "ondemand")):
                legs.append(dict(seed=10 * donate + k, donate=donate,
                                 policy=policy,
                                 prefill_chunk=None if donate else 3))
        if arch == "qwen2.5-14b":
            legs.append(dict(seed=7, paged_kernel=True, policy="reserve"))
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


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "minicpm3-4b",
                                  "mamba2-780m"])
def test_tp_grid_model_2_equals_single_device(arch, mesh2):
    check_grid(arch, mesh2)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "minicpm3-4b",
                                  "mamba2-780m"])
def test_tp_grid_model_4_equals_single_device(arch, mesh4):
    check_grid(arch, mesh4)


def test_split_gqa_group(mesh2):
    """4 query heads over 2 KV heads at model 2: each rank holds one KV
    head and its group of 2 query heads (the tiny default is 4 / 4)."""
    cfg, params, prompts, ref = build("qwen2.5-14b", n_kv_heads=2)
    for seed, kw in ((0, {}), (1, dict(paged_kernel=True)),
                     (2, dict(policy="ondemand"))):
        got, _ = run_leg(cfg, params, prompts, mesh2, seed, **kw)
        for rid, toks in got.items():
            assert np.array_equal(toks, ref[rid, :len(toks)]), (kw, rid)


def _serve_all(cfg, params, prompts, mesh, first_alone=False, **kw):
    """Every prompt to GEN_MAX tokens; with ``first_alone`` the first one
    completes before the others arrive (so they can hit its pages)."""
    eng = ServeEngine(cfg, params, slots=3, cache_len=24, mesh=mesh,
                      n_cores=4, device="cpu", **kw).start()
    reqs = [Request(i, p, max_new_tokens=GEN_MAX)
            for i, p in enumerate(prompts)]
    eng.submit(reqs[0])
    if first_alone:
        reqs[0].done.wait(DRAIN_S)
    for r in reqs[1:]:
        eng.submit(r)
    stats = drain(eng, reqs, DRAIN_S)
    return [np.asarray(r.wait()).tolist() for r in reqs], stats


def test_prefix_cache_under_tp(mesh2):
    cfg, params, _, _ = build("qwen2.5-14b")
    rng = np.random.default_rng(5)
    head = rng.integers(0, cfg.vocab, 10)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab, 3)]).astype(
        np.int32) for _ in range(4)]
    kw = dict(page_size=4, prefill_chunk=4, prefix_cache="on")
    single, s1 = _serve_all(cfg, params, prompts, None, True, **kw)
    tp, s2 = _serve_all(cfg, params, prompts, mesh2, True, **kw)
    assert tp == single
    assert s2["prefix_hits"] == s1["prefix_hits"] == 3
    assert s2["cow_forks"] > 0


def test_speculative_decoding_under_tp(mesh2):
    cfg, params, _, _ = build("qwen2.5-14b")
    rng = np.random.default_rng(6)
    motif = rng.integers(0, cfg.vocab, 3)
    prompts = [np.tile(motif, 4)[:10 + i].astype(np.int32) for i in range(3)]
    off, _ = _serve_all(cfg, params, prompts, None, page_size=4)
    single, s1 = _serve_all(cfg, params, prompts, None, page_size=4,
                            spec="ngram", spec_k=3)
    tp, s2 = _serve_all(cfg, params, prompts, mesh2, page_size=4,
                        spec="ngram", spec_k=3)
    assert tp == single == off
    assert s2["spec_drafted"] == s1["spec_drafted"] > 0


# ------------------------------------------------------ systems invariants
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "minicpm3-4b",
                                  "mamba2-780m"])
def test_tp_footprint_table_collectives_and_donation(arch, mesh2):
    """One decode tick dispatched by hand on an engine that is not
    started (the reference's ``test_tp_engine_collectives_footprint_and_
    donation``): per-rank pool bytes against the single-device pool at
    the same slots and pages, the tensors each rank was handed, the
    collectives of the tick, the pool updated in place."""
    cfg, params, _, _ = build(arch)
    page = None if arch == "mamba2-780m" else PAGE
    eng = ServeEngine(cfg, params, slots=3, cache_len=CACHE_LEN, mesh=mesh2,
                      page_size=page, paged_kernel=page is not None,
                      n_cores=4, device="cpu")
    try:
        sess, kv = eng._tp, eng.kv
        whole = KVState(cfg, 3, CACHE_LEN, torch.float32, page_size=page,
                        device="cpu").cache
        want = {k: b for k, (b, _) in tree_bytes(None, whole).items()}
        before = sess.run(tree_bytes, kv.cache)
        assert before[0].keys() == want.keys()
        n_half = 0
        for path, full in want.items():
            name = path.rsplit("/", 1)[-1]
            for rank in before:
                got = rank[path][0]
                if name in ("k", "v", "state"):
                    assert got * 2 == full, path
                    n_half += 1
                elif name == "conv":    # x channels of its heads + B, C
                    di, tail = cfg.d_inner, 2 * cfg.ssm_ngroups * \
                        cfg.ssm_state
                    assert got * (di + tail) == full * (di // 2 + tail)
                else:                   # MLA latents, pos: whole
                    assert got == full, path
        # MLA holds no head-split leaf: its latents are whole on each rank
        split = sum(p.rsplit("/", 1)[-1] in ("k", "v", "state") for p in want)
        assert n_half == 2 * split and (split > 0) == (arch != "minicpm3-4b")
        sess.run(counters, True)
        args = (eng._params, kv.cache, eng._tokens, eng._active_dev)
        if page is not None:
            args += (kv.table_dev,)
        _, new_cache = eng.decode(*args)
        kv.commit(new_cache)
        # every rank was handed the same whole tokens, mask and table
        digests = sess.run(seen, "decode")
        assert all(d == digests[0] for d in digests)
        if page is not None:
            assert digests[0][-1][0] == (3, CACHE_LEN // PAGE)
        # the tick's collectives: 2 a layer (after the mixer's output
        # projection — and the SSD's gated-norm statistic — and after the
        # MLP's, or for mamba2 the mixer's two), the embedding, the logits
        got = sess.run(counters)
        layers = cfg.n_layers
        for c in got:
            assert c["tp_all_reduce"] == 2 * layers + 1, c
            assert c["tp_all_gather"] == 1, c
        # the pool updated in place on every rank
        after = sess.run(tree_bytes, kv.cache)
        for b, a in zip(before, after):
            for path, (_, ptr) in b.items():
                if not path.endswith("/pos"):
                    assert a[path][1] == ptr, path
    finally:
        eng.shutdown()


def test_sharded_logits_within_f32_tolerance(mesh2):
    """Prefill logits and one decode tick's argmax through a Session
    against single-device.  The all-reduces sum each row-parallel
    product's per-rank partials, in another order than one device's
    product: f32 rounding, about 1e-7 relative a sum, through two
    layers.  Bound: 1e-5 of the logits' largest magnitude."""
    cfg, params, prompts, _ = build("qwen2.5-14b")
    tok = torch.tensor(prompts)
    cache, want = make_prefill_step(cfg, cache_len=CACHE_LEN)(params, tok)
    sess = Session(mesh2, cfg, "cpu")
    try:
        sp = sess.load(params)
        prefill = sess.step("prefill", make_prefill_step, cache_len=CACHE_LEN)
        serve = sess.step("serve", make_serve_step)
        tcache, got = prefill(sp, tok)
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err
        assert err > 0 or torch.equal(got, want)
        nxt = want.argmax(-1).int()
        a, _ = make_serve_step(cfg)(params, cache, nxt)
        b, _ = serve(sp, tcache, nxt)
        assert torch.equal(a, b)
        rows = greedy_oneshot(prefill, serve, sp, tok, None, GEN_MAX)
        assert rows.shape == (N_REQ, GEN_MAX)
    finally:
        sess.close()


# ------------------------------------------------------------------ errors
def test_a_failing_follower_fails_the_live_requests():
    cfg, params, prompts, _ = build("qwen2.5-14b")
    mesh = make_mesh_from_devices("1,2", device_type="cpu")
    try:
        eng = ServeEngine(cfg, params, slots=3, cache_len=CACHE_LEN,
                          mesh=mesh, page_size=PAGE, n_cores=4,
                          device="cpu").start()
        reqs = [Request(i, prompts[i], max_new_tokens=GEN_MAX)
                for i in range(N_REQ)]
        eng.submit(reqs[0])
        t = time.monotonic()
        while len(reqs[0].out_tokens) < 2:
            assert time.monotonic() - t < DRAIN_S
            time.sleep(0.01)
        assert eng._tp.run(tp_faults.mlp_raises_on_rank, 1, 0) == [0, 1]
        for r in reqs[1:]:
            eng.submit(r)
        t0 = time.monotonic()
        with pytest.raises(TPError, match="planted fault on rank 1"):
            drain(eng, reqs, DRAIN_S)
        assert time.monotonic() - t0 < 30
        failed = [r for r in reqs if r.error is not None]
        assert failed and all(r.done.is_set() for r in reqs)
        assert all(isinstance(r.error, TPError) for r in failed)
        assert mesh.closed                  # the followers were torn down
    finally:
        mesh.close()


def test_what_is_not_ported_raises():
    cfg, params, _, _ = build("qwen2.5-14b")
    # MoE under a mesh is ported: mixtral's steps build on 1,2 and rank
    # 0's shard holds every expert at half its d_ff columns (rank 0's
    # view of a mesh, no processes; tests/test_torch_moe_mesh.py serves)
    moe_cfg, moe_params, _, _ = build("mixtral-8x7b")
    mesh12 = Mesh({"data": 1, "model": 2})
    assert callable(make_prefill_step(moe_cfg, cache_len=CACHE_LEN,
                                      mesh=mesh12))
    assert callable(make_serve_step(moe_cfg, mesh=mesh12))
    part = shard_params(moe_params, moe_cfg, mesh12)
    mlp, whole = part["blocks"][0]["mlp"], moe_params["blocks"][0]["mlp"]
    assert mlp["w_gate"].shape[-1] * 2 == whole["w_gate"].shape[-1]
    assert mlp["w_down"].shape[-2] * 2 == whole["w_down"].shape[-2]
    assert torch.equal(mlp["router"], whole["router"])
    # head counts the model axis does not divide serve (item 20), whole
    # on every rank: the steps build at model 3 and rank 0 holds every
    # head; SSD heads it does not divide (mamba2-780m-tiny's 8) still
    # raise (item 20b)
    mesh13 = Mesh({"data": 1, "model": 3})
    assert callable(make_prefill_step(cfg, cache_len=CACHE_LEN,
                                      mesh=mesh13))
    assert callable(make_serve_step(cfg, mesh=mesh13))
    mixer = shard_params(params, cfg, mesh13)["blocks"][0]["mixer"]
    assert torch.equal(mixer["wq"], params["blocks"][0]["mixer"]["wq"])
    ssm_cfg, ssm_params, _, _ = build("mamba2-780m")
    with pytest.raises(NotImplementedError, match="item 20b"):
        ServeEngine(ssm_cfg, ssm_params, device="cpu", mesh=mesh13)
    with pytest.raises(NotImplementedError, match="serving splits no data"):
        ServeEngine(cfg, params, device="cpu",
                    mesh=Mesh({"data": 2, "model": 1}))
    with pytest.raises(ValueError, match="tp=True needs"):
        ServeEngine(cfg, params, device="cpu", tp=True)
    with pytest.raises(ValueError, match="want 'DATA,MODEL'"):
        make_mesh_from_devices("1,x", device_type="cpu")


def test_cli_mesh_gives_the_same_tokens():
    rows = {}
    for mesh in ("1,1", "1,2"):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--tiny",
             "--device", "cpu", "--mesh", mesh, "--batch", "2",
             "--requests", "3", "--prompt-len", "8", "--gen", "4",
             "--cores", "3", "--paged-kernel"],
            capture_output=True, text=True, timeout=120, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), check=True)
        rows[mesh] = json.loads(out.stdout.strip().splitlines()[-1])
        assert f"model={mesh[-1]}" in out.stderr
    assert rows["1,2"]["sample"] == rows["1,1"]["sample"]
    assert rows["1,2"]["tp"] is True and rows["1,1"]["tp"] is False
    assert rows["1,2"]["tp_backend"] == "gloo"
