"""Tensor parallelism in training on the port (``steps.make_train_step(cfg,
hp, mesh=)`` on a ``D,M`` mesh driven by ``launch.train.MeshTrain``), on
the CPU: each mesh is rank 0 (this process) and follower processes on
gloo, tiny f32 configs, the state carried over from the reference's
``init_train_state`` as numpy.

  * Against the reference: three port steps on meshes 1,2 and 2,2 from
    the reference's state, on its batches, against the reference's
    single-device ``jax.jit(make_train_step(cfg, None, hp))``, for
    qwen2.5-14b, minicpm3-4b, mamba2-780m, internvl2-2b and
    musicgen-large, by the bars of ``tests/fsdp_ref.py``.  The
    reference's own sharded step does not run on this jax (ROADMAP queue
    3), so the oracle is its single-device step.
  * Per-rank bytes of params, m and v on 2,2 by rule: 1/4 of a leaf split
    on both axes (mixtral's experts among them), 1/2 of a leaf split on
    one, the SSD mixer's ``TP_LOCAL`` leaves by their formula, replicated
    leaves whole.
  * Collectives a step on each group by formula, under remat "full" and
    "none" (a MoE layer: a dense MLP's, one more enter for its combine
    weights, and its load-balance term's data sums).
  * The parts of params, m and v whole on every model rank stay equal
    across the model group bit for bit after every one of three steps
    (mixtral's router too).
  * Each planted fault of ``chip_smoke``'s TP train section fails the
    bars.
  * The given-statistic backward's plain path, a row split over two
    and over four ranks, equals the reference's ``jax.vjp`` of the whole
    row's norm; a local row term and one ``dw`` partial left out each
    fail.
  * ``chip_smoke.tp_train_section`` rehearsed at the tiny configs.

Checkpoints across 2-D meshes: ``tests/test_torch_fsdp_checkpoint.py``.
"""
import numpy as np
import pytest
import torch

from fsdp_ref import ACCUM, chip_smoke, mesh_train, misses, reference, \
    run_mesh
from repro_torch.configs import get
from repro_torch.kernels import (rms_norm_bwd_rstd, rms_norm_bwd_rstd_ref,
                                 rms_norm_dot, rms_norm_dot_ref, rms_norm_ref,
                                 rms_norm_rstd)
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.lm import LeafMeta, param_meta
from repro_torch.params import train_state_from_numpy
from repro_torch.serve.tp import counters, tree_bytes

ARCHS = ["qwen2.5-14b", "minicpm3-4b", "mamba2-780m", "internvl2-2b",
         "musicgen-large"]


@pytest.fixture(scope="module")
def mesh12():
    with make_mesh_from_devices("1,2", device_type="cpu") as m:
        yield m


@pytest.fixture(scope="module")
def mesh22():
    with make_mesh_from_devices("2,2", device_type="cpu") as m:
        yield m


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", ["1,2", "2,2"])
def test_sharded_steps_match_the_reference(arch, spec, mesh12, mesh22):
    ref = reference(arch)
    mesh = {"1,2": mesh12, "2,2": mesh22}[spec]
    metrics, leaves, _ = run_mesh(arch, mesh, ref)
    assert misses(ref, metrics, leaves) == []


def leaf_paths(cfg):
    """(path, leaf meta, in an SSD mixer) of every parameter leaf, in
    ``tree_leaves`` order."""
    out = []

    def walk(t, path, ssm):
        if isinstance(t, LeafMeta):
            out.append((path, t, ssm))
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}", ssm)
        else:
            for i, x in enumerate(t):
                walk(x, f"{path}[{i}]",
                     cfg.pattern[i].kind == "ssm" if path == "/blocks"
                     else ssm)
    walk(param_meta(cfg), "", False)
    return out


def share(cfg, path, meta, ssm):
    """The bytes a rank of a 2,2 mesh holds of a leaf, over its whole
    bytes, by rule: "fsdp" (d_model 64) halves on data; "tp", "vocab"
    and the heads' dims halve on model; in an SSD mixer ``wxBC``,
    ``conv_w`` and ``conv_b`` keep half the x channels and all of B and
    C, ``wdt``, ``dt_bias``, ``A_log``, ``Dskip`` and ``norm_w`` half
    their entries (``models.ssm.TP_LOCAL``); the rest whole."""
    name = path.rsplit("/", 1)[-1]
    frac = 0.5 if "fsdp" in meta.axes else 1.0
    if ssm and name in ("wxBC", "conv_w", "conv_b"):
        bc = 2 * cfg.ssm_ngroups * cfg.ssm_state
        return frac * (cfg.d_inner / 2 + bc) / (cfg.d_inner + bc)
    if ssm and name in ("wdt", "dt_bias", "A_log", "Dskip", "norm_w"):
        return frac / 2
    if any(a in ("tp", "vocab") for a in meta.axes):
        return frac / 2
    return frac


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-780m",
                                  "minicpm3-4b", "mixtral-8x7b"])
def test_each_rank_holds_its_share_by_rule(arch, mesh22):
    cfg = get(arch).tiny()
    ref = reference(arch)
    whole = tree_bytes(None, train_state_from_numpy(ref.state0, cfg, "cpu"))
    tr = mesh_train(arch, mesh22, ref.state0)
    try:
        per_rank = tr.sess.run(tree_bytes, tr.state)
    finally:
        tr.close()
    shares = {path: share(cfg, path, m, ssm)
              for path, m, ssm in leaf_paths(cfg)}
    kinds = set()
    for held in per_rank:
        assert held.keys() == whole.keys()
        for path, (b, _) in whole.items():
            leaf = next((path[len(pre):] for pre in ("/params", "/opt/m",
                                                     "/opt/v")
                         if path.startswith(pre)), None)
            want = b if leaf is None else b * shares[leaf]
            assert held[path][0] == want, (path, held[path][0], want)
            kinds.add(None if leaf is None else shares[leaf])
    # some leaf of each class: both axes (1/4), one axis (1/2), whole
    assert {0.25, 0.5, 1.0} <= kinds, kinds


def formula(cfg, remat):
    """The collectives of one step of ``ACCUM`` microbatches on a rank of
    a 2,2 mesh.  Model group: per microbatch the embedding's all-reduce,
    per layer its mixer's output (and an SSD layer's gated-norm
    statistic) and a dense or MoE MLP's output, under remat "full" each
    repeat's again but its closing one (the recompute stops at the last
    tensor the backward saved); one all-gather of the logits; the enter
    op's backward per GQA layer 1, per MLA layer 3, per SSD layer 4 (xn
    and the B/C columns of three leaves), per dense MLP 1, per MoE layer
    2 (its input and its combine weights), and the LM head's 1; per SSD
    layer the gated norm's row term; the clip norm's one a step.  Data
    group: each split leaf gathered once a microbatch and once more in
    the recompute, its gradient summed once, plus four sums (whole
    leaves' gradients, label counts, loss, clip norm), plus per MoE layer
    and microbatch the load-balance term's means, again in the
    recompute."""
    spec = cfg.pattern[0]
    ssm, mla = spec.kind == "ssm", spec.attn == "mla"
    dense, moe = spec.mlp == "dense", spec.mlp == "moe"
    fwd = 1 + ssm + dense + moe
    layers = cfg.n_repeats          # one layer a repeat
    again = layers * (fwd - 1) if remat == "full" else 0
    remats = 2 if remat == "full" else 1
    enter = (4 if ssm else 3 if mla else 1) + dense + 2 * moe
    split = [m for _, m, _ in leaf_paths(cfg) if "fsdp" in m.axes]
    in_blocks = layers * sum(m.axes[0] == "stack" for m in split)
    outside = len(split) - in_blocks // layers
    return {"tp_all_reduce": ACCUM * (1 + layers * fwd + again),
            "tp_all_gather": ACCUM, "tp_enter": ACCUM * (1 + layers * enter),
            "tp_norm_dot": ACCUM * layers * ssm, "tp_sum": 1,
            "fsdp_gather": ACCUM * (remats * in_blocks + outside),
            "fsdp_sum": ACCUM * (in_blocks + outside
                                 + remats * layers * moe) + 4}


@pytest.mark.parametrize("arch,remat", [("qwen2.5-14b", "full"),
                                        ("qwen2.5-14b", "none"),
                                        ("mamba2-780m", "full"),
                                        ("minicpm3-4b", "none"),
                                        ("mixtral-8x7b", "full")])
def test_collectives_follow_the_formula(arch, remat, mesh22):
    cfg = get(arch).tiny(remat=remat)
    ref = reference(arch)
    tr = mesh_train(arch, mesh22, ref.state0, remat=remat)
    try:
        tr.sess.run(counters, True)
        tr.state, _ = tr.step(tr.state, ref.batches[0])
        count = tr.sess.run(counters)
    finally:
        tr.close()
    want = formula(cfg, remat)
    for c in count:
        assert {k: c[k] for k in want} == want, (c, want)
        # each collective carried its bytes
        assert all(c[f"{k}_bytes"] > 0 for k in want
                   if k.startswith("tp") and want[k])


@pytest.mark.parametrize("arch", ["mamba2-780m", "minicpm3-4b",
                                  "mixtral-8x7b"])
def test_replicated_parts_stay_bit_equal_across_model_ranks(arch, mesh22):
    """mamba2's B and C columns and norm weights, minicpm3's ``wq_a``,
    ``wkv_a`` and latent norms, mixtral's router and norms: equal on both
    ranks of each model group after each of three steps, in params, m
    and v.  Rank 0 computes on
    one thread, as the CPU followers do: bit-equality is that of one
    computation in one order on every rank (on the card the ranks run
    the same kernels), and a CPU product on more threads may sum in
    another order."""
    ref = reference(arch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tr = mesh_train(arch, mesh22, ref.state0)
    try:
        for b in ref.batches:
            tr.state, _ = tr.step(tr.state, b)
            checked = tr.sess.run(chip_smoke.tp_train_same, tr.state)
            for n, nbytes, bad in checked:
                assert n > 0 and nbytes > 0 and bad == [], bad
    finally:
        tr.close()
        torch.set_num_threads(threads)


@pytest.mark.parametrize("fault", chip_smoke.TP_TRAIN_FAULTS)
def test_planted_faults_fail_the_bars(fault, mesh22):
    """Each on mamba2-780m, but the clip norm's: at its tiny shape the
    parts whole on every model rank (B and C, two norm weights) hold
    1.6e-4 of the gradient's squares, below the grad norm's bar, so that
    one runs on minicpm3-4b, whose latent projections are whole too."""
    arch = ("minicpm3-4b" if fault == "clip_norm_replicated_m_times"
            else "mamba2-780m")
    ref = reference(arch)
    metrics, leaves, _ = run_mesh(arch, mesh22, ref, fault=fault)
    assert misses(ref, metrics, leaves), fault


def _row_case(seed=3, rows=24, width=32):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((rows, width), np.float32))
    w = torch.tensor(rng.standard_normal(width, np.float32) * 0.1 + 1.0)
    dy = 0.5 * x + torch.tensor(rng.standard_normal((rows, width),
                                                    np.float32))
    return x, w, dy


def _whole_row_grads(x, w, dy, eps):
    """dx and dw of the whole row's norm: autograd through ``rms_norm_ref``
    (f32), held to the reference's ``jax.vjp``; returned as numpy."""
    import jax
    import jax.numpy as jnp

    from repro.models.layers import rms_norm as jrms

    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    rms_norm_ref(xg, wg, eps).backward(dy)
    _, vjp = jax.vjp(lambda a, b: jrms(a, b, eps), jnp.asarray(x.numpy()),
                     jnp.asarray(w.numpy()))
    jdx, jdw = (np.asarray(t) for t in vjp(jnp.asarray(dy.numpy())))
    np.testing.assert_allclose(xg.grad.numpy(), jdx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wg.grad.numpy(), jdw, rtol=1e-5, atol=1e-5)
    return jdx, jdw


def _split_equals_the_whole_row(ranks):
    """A row of 32 split into ``ranks`` equal parts: each part's forward
    given the whole row's statistic, each part's row term summed with the
    others' (what the all-reduce over the model group gives), and each
    part's dx and dw equal the reference's ``jax.vjp`` of the whole row's
    ``rms_norm`` (and autograd through ``rms_norm_ref``) in f32, through
    autograd and through the two entries called directly; with the sum
    left out (the planted local row term), dx is off."""
    x, w, dy = _row_case()
    eps, width = 1e-5, x.shape[1]
    jdx, jdw = _whole_row_grads(x, w, dy, eps)
    rstd = torch.rsqrt(x.square().mean(-1) + eps)
    cut = width // ranks
    parts = [slice(k * cut, (k + 1) * cut) for k in range(ranks)]
    dots = [rms_norm_dot(x[:, h], w[h], dy[:, h], rstd) for h in parts]
    for (s, partials), h in zip(dots, parts):
        want = rms_norm_dot_ref(x[:, h], w[h], dy[:, h], rstd)
        np.testing.assert_allclose(s.numpy(), want[0].numpy())
        assert partials.shape == (1, cut)
    total = sum(s for s, _ in dots)
    for k, h in enumerate(parts):
        others = total - dots[k][0]
        xk, wk = x[:, h].clone().requires_grad_(), \
            w[h].clone().requires_grad_()
        y = rms_norm_rstd(xk, wk, rstd, width=width,
                          reduce=lambda s, o=others: s + o)
        np.testing.assert_allclose(y.detach().numpy(),
                                   rms_norm_ref(x, w, eps)[:, h].numpy(),
                                   rtol=1e-5, atol=1e-6)
        y.backward(dy[:, h])
        np.testing.assert_allclose(xk.grad.numpy(), jdx[:, h], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(wk.grad.numpy(), jdw[h], rtol=1e-5,
                                   atol=1e-5)
        # the entries called directly, pass 1's dw in three partials
        _, partials = rms_norm_dot_ref(x[:, h], w[h], dy[:, h], rstd,
                                       parts=3)
        dx, dw = rms_norm_bwd_rstd(x[:, h], w[h], dy[:, h], rstd, total,
                                   width, partials)
        np.testing.assert_allclose(dx.numpy(), jdx[:, h], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(dw.numpy(), jdw[h], rtol=1e-5, atol=1e-5)
        local, _ = rms_norm_bwd_rstd_ref(x[:, h], w[h], dy[:, h], rstd,
                                         dots[k][0], width, partials)
        assert not np.allclose(local.numpy(), jdx[:, h], rtol=1e-2,
                               atol=1e-3)


def test_given_statistic_backward_split_over_two_ranks_equals_autograd():
    """Halves of the row (model 2): ``_split_equals_the_whole_row``."""
    _split_equals_the_whole_row(2)


def test_given_statistic_backward_split_over_four_ranks_equals_autograd():
    """Quarters of the row (model 4): ``_split_equals_the_whole_row``."""
    _split_equals_the_whole_row(4)


def test_given_statistic_backward_dw_partial_left_out_fails():
    """The planted fault of the two-pass design: pass 1's ``dw`` partials
    of one rank's half, one of four left out of pass 2's sum (zeroed), so
    dw misses the reference's ``jax.vjp`` by far more than its
    tolerance; the four kept give it within 1e-5, dx either way."""
    x, w, dy = _row_case()
    eps, width = 1e-5, x.shape[1]
    jdx, jdw = _whole_row_grads(x, w, dy, eps)
    rstd = torch.rsqrt(x.square().mean(-1) + eps)
    halves = [slice(0, width // 2), slice(width // 2, width)]
    total = sum(rms_norm_dot_ref(x[:, h], w[h], dy[:, h], rstd)[0]
                for h in halves)
    h = halves[0]
    _, partials = rms_norm_dot_ref(x[:, h], w[h], dy[:, h], rstd, parts=4)
    dx, dw = rms_norm_bwd_rstd(x[:, h], w[h], dy[:, h], rstd, total, width,
                               partials)
    np.testing.assert_allclose(dw.numpy(), jdw[h], rtol=1e-5, atol=1e-5)
    partials[1] = 0.0
    bad_dx, bad = rms_norm_bwd_rstd(x[:, h], w[h], dy[:, h], rstd, total,
                                    width, partials)
    np.testing.assert_allclose(bad_dx.numpy(), dx.numpy())
    rel = np.linalg.norm(bad.numpy() - jdw[h]) / np.linalg.norm(jdw[h])
    assert rel > 100 * 1e-5, rel


def test_chip_smoke_tp_train_section_rehearses_on_the_cpu():
    """``chip_smoke.tp_train_section`` on the CPU (``device="cpu"``: tiny
    configs): its legs, bars, planted faults, counts and checkpoint run
    to the end."""
    launches = chip_smoke.tp_train_section("cpu", device="cpu")
    assert set(launches) >= {"rms_norm", "rms_norm_bwd", "rms_norm_dot",
                             "rms_norm_bwd_rstd", "ssd_scan",
                             "ssd_scan_bwd"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_given_statistic_backward_kernels_match_plain(dtype, cuda):
    """The two Triton entries through autograd at mamba2's two-rank gated
    norm shape (4096, 1536 of 3072), each launched once, against the
    plain entries: dx by the kernel tests' tolerances, dw by its relative
    L2 error."""
    tol = {"float32": dict(rtol=2e-5, atol=2e-5),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}[dtype]
    dw_tol = {"float32": 1e-5, "bfloat16": 2e-3}[dtype]
    dt = getattr(torch, dtype)
    x, w, dy = (t.to(cuda) for t in _row_case(5, 4096, 3072))
    rstd = torch.rsqrt(x.square().mean(-1) + 1e-5)
    h = slice(0, 1536)
    other, _ = rms_norm_dot_ref(x[:, 1536:], w[1536:], dy[:, 1536:], rstd)
    xk = x[:, h].to(dt).contiguous().requires_grad_()
    wk = w[h].to(dt).contiguous().requires_grad_()
    d0 = rms_norm_dot.launches.value
    b0 = rms_norm_bwd_rstd.launches.value
    y = rms_norm_rstd(xk, wk, rstd, width=3072,
                      reduce=lambda s: s + other)
    y.backward(dy[:, h].to(dt))
    torch.cuda.synchronize()
    assert rms_norm_dot.launches.value == d0 + 1
    assert rms_norm_bwd_rstd.launches.value == b0 + 1
    xd, wd, dyd = xk.detach(), wk.detach(), dy[:, h].to(dt)
    s, partials = rms_norm_dot_ref(xd, wd, dyd, rstd)
    dx, dw = rms_norm_bwd_rstd_ref(xd, wd, dyd, rstd, s + other, 3072,
                                   partials)
    np.testing.assert_allclose(xk.grad.float().cpu().numpy(),
                               dx.float().cpu().numpy(), **tol)
    rel = ((wk.grad.float() - dw.float()).norm() / dw.float().norm()).item()
    assert rel <= dw_tol, rel
