"""Replicated heads under tensor parallelism on the port: head counts the
model axis does not divide, whole on every rank as the reference's strict
rules replicate them, with the weights still cut by the rules (mid-head
columns gathered whole, ``models.attention``).  On the CPU, one 1,4 mesh
(rank 0 and three gloo followers), tiny f32 configs:

  * qwen2.5-14b-tiny with 10 query and 2 KV heads at model 4: 2.5 query
    heads' and half a KV head's columns a rank, qwen2.5-14b's layout on
    16 in small.  The serve legs of ``tests/test_torch_tp.py::check_grid``
    (donate x {reserve, ondemand}, chunked prefill, the paged-kernel leg)
    give the reference's single-device one-shot tokens bit for bit, and
    one and two train steps meet ``tests/fsdp_ref.py``'s bars against the
    reference's single-device step.
  * 4 query and 2 KV heads at model 4: the query heads split (one a rank)
    and the KV heads do not, so rank r's head reads KV head r // 2 of
    the whole pool (trap 3).  Serve legs only.
  * 12 query and 3 KV heads at model 4: a split of 3 query heads a rank
    would read KV heads of uneven groups, so the query heads are whole on
    every rank too (``wq``'s columns cut at head boundaries, ``wk``'s
    mid-head).  Serve legs only.
  * minicpm3-4b-tiny with 6 MLA heads at model 4 (1.5 heads' columns a
    rank; ``wq_b``, ``wk_b`` and ``wv_b`` gathered whole): serve legs and
    train steps.
  * The planted faults of ``chip_smoke.HEADS_FAULTS`` fail: ``xn``
    entering a replicated section, the whole output narrowed without
    entering, query heads reading their KV head counted from 0.
  * An SSD head count the model axis does not divide still raises,
    naming item 20b.
  * ``chip_smoke``'s 1,3 leg (qwen2.5-14b, every head whole on every
    rank) rehearsed on a CPU 1,3 mesh at its tiny layout.
  * The paged GQA decode kernel reading a view of a pool's heads in
    place is held on the card by ``tests/test_torch_kernels.py::
    test_paged_decode_reads_a_head_view_of_the_pool`` (``-m gpu``).
"""
import numpy as np
import pytest
import torch

from fsdp_ref import chip_smoke, misses, reference, run_mesh
from repro_torch.configs import get
from repro_torch.launch.mesh import Mesh, make_mesh_from_devices
from repro_torch.models.layers import tp_heads
from repro_torch.optim import OptHParams
from repro_torch.params import shard_params
from repro_torch.serve.tp import Session
from repro_torch.sharding import sharding_ctx
from repro_torch.steps import (TP_SERVE_RULES, check_tp, check_train_mesh,
                               make_prefill_step, make_train_step)
from test_torch_tp import CACHE_LEN, build, run_leg

QWEN_10_2 = dict(n_heads=10, n_kv_heads=2)
QWEN_4_2 = dict(n_kv_heads=2)
QWEN_12_3 = dict(n_heads=12, n_kv_heads=3)
MLA_6 = dict(n_heads=6)


@pytest.fixture(scope="module")
def mesh14():
    with make_mesh_from_devices("1,4", device_type="cpu") as m:
        yield m


def serve_legs(arch, mesh, **over):
    """``check_grid``'s serve legs on ``arch``'s tiny config with
    ``over``: every request's tokens equal the reference's one-shot rows
    and the single-device engine's."""
    cfg, params, prompts, ref = build(arch, **over)
    legs = []
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


@pytest.mark.parametrize("arch,over", [("qwen2.5-14b", QWEN_10_2),
                                       ("qwen2.5-14b", QWEN_4_2),
                                       ("qwen2.5-14b", QWEN_12_3),
                                       ("minicpm3-4b", MLA_6)],
                         ids=["qwen-10-2", "qwen-4-2", "qwen-12-3",
                              "minicpm3-6"])
def test_replicated_heads_serve_the_reference_tokens(arch, over, mesh14):
    serve_legs(arch, mesh14, **over)


@pytest.mark.parametrize("arch,over", [("qwen2.5-14b", QWEN_10_2),
                                       ("minicpm3-4b", MLA_6)],
                         ids=["qwen-10-2", "minicpm3-6"])
def test_replicated_heads_train_within_the_bars(arch, over, mesh14):
    """One and two steps from the reference's state on 1,4 against its
    single-device steps (``fsdp_ref``'s bars: the misses of the run
    after step 1, then after step 2)."""
    ref = reference(arch, steps=2, **over)
    one = ref._replace(batches=ref.batches[:1])
    metrics, leaves, _ = run_mesh(arch, mesh14, one, **over)
    assert misses(ref, metrics, leaves) == []
    metrics, leaves, _ = run_mesh(arch, mesh14, ref, **over)
    assert misses(ref, metrics, leaves) == []


@pytest.mark.parametrize("fault,arch,over", [
    ("xn_enters_whole", "minicpm3-4b", MLA_6),
    ("out_narrowed_unentered", "qwen2.5-14b", QWEN_10_2)])
def test_planted_train_faults_fail_the_bars(fault, arch, over, mesh14):
    """``xn`` entering a replicated section (MLA's ``xn`` meets only whole
    weights, and its latents meet whole heads) and the whole output
    narrowed to the rank's rows of ``wo`` without entering: each misses
    the bars after one step."""
    ref = reference(arch, steps=2, **over)
    one = ref._replace(batches=ref.batches[:1])
    metrics, leaves, _ = run_mesh(arch, mesh14, one, fault=fault, **over)
    assert misses(ref, metrics, leaves), fault


def prefill_logits(cfg, params, prompts, mesh, fault=None):
    """Prefill logits of ``prompts`` through a Session on ``mesh``, with
    ``fault`` (``chip_smoke.tp_fault_on``) planted on every rank."""
    sess = Session(mesh, cfg, "cpu")
    try:
        if fault:
            sess.run(chip_smoke.tp_fault_on, fault)
        sp = sess.load(params)
        prefill = sess.step("prefill", make_prefill_step,
                            cache_len=CACHE_LEN)
        _, got = prefill(sp, torch.tensor(prompts))
        if fault:
            sess.run(chip_smoke.tp_fault_off, fault)
        return got
    finally:
        sess.close()


def test_kv_read_from_0_fails(mesh14):
    """Trap 3 planted: each rank's query head reads KV head 0's view, not
    KV head ``q0 // group``.  The prefill logits as built are within the
    f32 bound of ``test_torch_tp.py`` (1e-5 of the largest magnitude);
    the fault's are off by more than 100 times that."""
    cfg, params, prompts, _ = build("qwen2.5-14b", **QWEN_4_2)
    _, want = make_prefill_step(cfg, cache_len=CACHE_LEN)(
        params, torch.tensor(prompts))
    bound = 1e-5 * want.abs().max().item()
    got = prefill_logits(cfg, params, prompts, mesh14)
    assert (got - want).abs().max().item() <= bound
    bad = prefill_logits(cfg, params, prompts, mesh14, "kv_read_from_0")
    assert (bad - want).abs().max().item() > 100 * bound


def test_the_layout_by_rule_and_what_still_raises():
    """Rank 1's view of a 1,4 mesh (no processes): qwen2.5-14b-tiny at
    10/2 heads keeps the rules' mid-head cuts (40 of 160 ``wq`` columns,
    8 of 32 ``wk`` columns, 40 of 160 ``wo`` rows); every rank's heads by
    ``tp_heads`` at 10/2, 4/2 and 12/3.  40/8 heads at model 3
    (the card's 1,3 leg) serve and train, whole on every rank.  An SSD
    head count the model axis does not divide raises naming item 20b, in
    serving and in training."""
    cfg = get("qwen2.5-14b").tiny(**QWEN_10_2)
    _, params, _, _ = build("qwen2.5-14b", **QWEN_10_2)
    part = shard_params(params, cfg, Mesh({"data": 1, "model": 4}, 1))
    mixer = part["blocks"][0]["mixer"]
    assert mixer["wq"].shape[-1] == 40 and mixer["wk"].shape[-1] == 8
    assert mixer["wo"].shape[-2] == 40
    whole = params["blocks"][0]["mixer"]["wq"]
    assert torch.equal(mixer["wq"], whole[..., 40:80])
    # every rank's heads: 10/2 (queries and KV whole), 4/2 (a query head
    # a rank on its KV head r // 2), 12/3 (whole: a split would read KV
    # heads of uneven groups)
    for r in range(4):
        with sharding_ctx(Mesh({"data": 1, "model": 4}, r), TP_SERVE_RULES):
            assert tp_heads(10, 2) == (10, 2, 0, 0, 5)
            assert tp_heads(4, 2) == (1, 2, r, 0, 2)
            assert tp_heads(4, 2).reads == (r // 2, 1)
            assert tp_heads(12, 3) == (12, 3, 0, 0, 4)
            assert tp_heads(12, 3).reads == (0, 3)
    full = get("qwen2.5-14b")
    mesh13 = Mesh({"data": 1, "model": 3})
    check_tp(full, mesh13)
    check_train_mesh(full, Mesh({"data": 2, "model": 3}), micro=4)
    assert callable(make_train_step(cfg, OptHParams(),
                                    Mesh({"data": 1, "model": 3})))
    ssm = get("mamba2-780m").tiny()
    assert ssm.ssm_nheads == 8
    with pytest.raises(NotImplementedError, match="item 20b"):
        check_tp(ssm, mesh13)
    with pytest.raises(NotImplementedError, match="item 20b"):
        make_train_step(ssm, OptHParams(), mesh13)


def test_chip_smoke_heads_leg_rehearses_on_the_cpu():
    """``chip_smoke.tp_leg``'s replicated-heads leg on a CPU 1,3 mesh at
    its tiny layout (10/2 heads and wq whole on every rank, d_ff and the
    vocab in thirds): K/V pools whole on every rank, three all-reduces a
    pass (the embedding, two MLPs; none after the attention), the logit
    checks to the planted faults' verdict.  At d 64 neither fault
    reaches the token bar (their argmax gaps 0.14 and 0.35 against 1.0),
    though both pass the relative one (0.36 and 0.91 against 0.3): the
    leg ends in that verdict, naming both (on the card they show)."""
    with make_mesh_from_devices("1,3", device_type="cpu") as mesh13:
        with pytest.raises(AssertionError) as err:
            chip_smoke.tp_leg(mesh13, "qwen2.5-14b-heads", "cpu", "cpu")
    assert str(err.value).endswith(
        "do not reject the planted TP faults ['ff_next_rank', "
        "'wo_whole_all_reduced']"), err.value

