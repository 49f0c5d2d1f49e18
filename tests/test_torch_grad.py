"""Gradients through the port's kernels.

RMSNorm and the SSD scan are the kernels on the training path, and the
two with a backward on the card: ``kernels/rmsnorm`` (``RMSNormFn``, whose
forward is the Triton forward saving ``rstd`` and whose backward is the
Triton backward) and ``kernels/ssd_chunk`` (``SSDScanFn``: the scan's
forward kernel, and ``ssd_scan_bwd``, the CUDA backward).  On the CPU the
norm's plain backward (``rms_norm_bwd_ref``) is held to ``jax.grad`` of
the reference's ``rms_norm`` (``src/repro/models/layers.py:11``) and to
autograd through the plain forward; the scan's plain backward is held in
``test_torch_ssd_grad.py``.  The other three CUDA wrappers (flash
attention, the paged decodes) have no backward: under autograd they raise
rather than hand back an output that carries no gradient
(``kernels.counter.forward_only``); on the CPU they take their plain
versions, which autograd differentiates.

The ``gpu`` cases hold both backward kernels to their plain backwards on
the card — the scan's through autograd in the model's layout (B and C one
group's view of stride 0 over the heads, as ``models/ssm.py`` hands them
over), at the reference's grid and at mamba2-780m's and jamba-v0.1-52b's
shapes — and check that each guarded wrapper raises there; they skip
here.

Tolerances.  CPU, f32: dx rtol 1e-5 / atol 1e-6 — XLA and PyTorch take
the row mean in another order.  Card: dx elementwise as the forward
kernel's (2e-5 in f32, 2e-2 in bf16; bf16 rows also held by
``ROW_TOL``), dw by its relative L2 error, 1e-5 in f32 (a sum over up
to 4096 rows in another order) and 2e-3 in bf16 (both round the same
f32 sums to bf16; an entry that rounds the other way is 2^-8 off, and
2e-3 allows some 6 % of entries to: ``chip_smoke.DW_TOL``).  The SSD
backward (``SSD_BWD_TOL``; ``chip_smoke.SSD_BWD_TOL``, ``SSD_ROW_TOL``): in f32 each
gradient elementwise within 1e-4 of itself plus 1e-4 of its largest value
(sums over up to 256 positions and 128 states in another order; ddt and
da come out of a reverse cumsum whose terms cancel, so their error is
held against the gradient's scale); in bf16 row by row against the plain
backward in f32 from the same bf16 inputs, RMS 1e-2 and worst row 5e-2:
the kernel's products take bf16 operands with f32 sums and it rounds dx,
dB and dC to bf16 (an H100 reads rows at an RMS of 2.4-3.1e-3), and
autograd sums the per-head dB and dC of a group in bf16; a chunk's dB
zeroed or dB times the head count is off by a whole row.  Its C B^T
launch against the plain phase: 1e-4 of the largest value (one f32 sum
of N exact products in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (flash_attention, paged_decode_attention,
                                 paged_mla_decode_attention, rms_norm,
                                 rms_norm_bwd, rms_norm_bwd_ref, rms_norm_ref,
                                 ssd_scan, ssd_scan_bwd, ssd_scan_ref)
from repro_torch.kernels.counter import forward_only

SHAPES = [(128, 256), (4, 32, 512), (1, 64), (7, 5120)]
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DW_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
ROW_TOL = dict(rms=1e-2, worst=5e-2)
SSD_BWD_TOL = dict(rtol=1e-4, atol_of_max=1e-4)
# (B, S, H, P, N, chunk): the reference's grid (tests/test_kernels.py:
# 205-209), mamba2-780m's train microbatch and jamba-v0.1-52b's prefill
SSD_BWD_SHAPES = [(1, 128, 2, 64, 32, 32), (2, 256, 4, 32, 64, 64),
                  (1, 64, 1, 16, 16, 64), (4, 1024, 48, 64, 128, 256),
                  (1, 2048, 128, 64, 16, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m gpu on the card)")
    return torch.device("cuda")


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, np.float32)
    w = (rng.standard_normal(shape[-1], np.float32) * 0.1 + 1.0)
    dy = rng.standard_normal(shape, np.float32)
    return x, w, dy


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_grad(shape):
    import jax
    import jax.numpy as jnp

    from repro.models.layers import rms_norm as jrms

    x, w, dy = _inputs(shape)
    _, vjp = jax.vjp(lambda a, b: jrms(a, b, 1e-5), jnp.asarray(x),
                     jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    dx, dw = rms_norm_bwd_ref(torch.tensor(x), torch.tensor(w),
                              torch.tensor(dy), 1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_cpu_wrapper_is_differentiated_by_autograd(shape):
    x, w, dy = _inputs(shape, 1)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    rms_norm(xt, wt).backward(torch.tensor(dy))
    dx, dw = rms_norm_bwd_ref(torch.tensor(x), torch.tensor(w),
                              torch.tensor(dy))
    np.testing.assert_allclose(xt.grad.numpy(), dx.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), dw.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_forward_only_raises_under_autograd_only():
    t = torch.ones(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        forward_only("k", torch.ones(3), t)
    with torch.no_grad():
        forward_only("k", t)
    forward_only("k", torch.ones(3))


def test_cpu_ssd_scan_carries_gradient():
    """mamba2 and jamba train on the CPU: the plain scan is differentiable."""
    rng = np.random.default_rng(2)
    b, s, h, p, n = 1, 16, 2, 4, 8
    x = torch.tensor(rng.standard_normal((b, s, h, p), np.float32),
                     requires_grad=True)
    dt = torch.tensor(rng.uniform(0.01, 0.1, (b, s, h)).astype(np.float32))
    a = -torch.tensor(rng.uniform(0.5, 2.0, h).astype(np.float32))
    bm = torch.tensor(rng.standard_normal((b, s, h, n), np.float32))
    cm = torch.tensor(rng.standard_normal((b, s, h, n), np.float32))
    y, _ = ssd_scan(x, dt, a, bm, cm, chunk=8)
    y.sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


# ------------------------------------------------------------------ card
def _row_rel(got, want):
    g, w = got.float(), want.float()
    n2 = w.square().sum(-1)
    r = (g - w).square().sum(-1)[n2 > 0] / n2[n2 > 0]
    return r.mean().sqrt().item(), r.max().sqrt().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + [(16, 1, 5120), (4096, 5120)])
def test_rms_norm_backward_kernel_matches_plain(shape, dtype, cuda):
    dt = getattr(torch, dtype)
    x, w, dy = (torch.tensor(a, device=cuda).to(dt) for a in _inputs(shape))
    xg = x.clone().requires_grad_()
    wg = w.clone().requires_grad_()
    f0, b0 = rms_norm.launches.value, rms_norm_bwd.launches.value
    y = rms_norm(xg, wg)
    y.backward(dy)
    torch.cuda.synchronize()
    assert rms_norm.launches.value == f0 + 1
    assert rms_norm_bwd.launches.value == b0 + 1
    dx, dw = rms_norm_bwd_ref(x, w, dy)
    np.testing.assert_allclose(xg.grad.float().cpu().numpy(),
                               dx.float().cpu().numpy(), **TOL[dtype])
    if dtype == "bfloat16":
        rms, worst = _row_rel(xg.grad, dx)
        assert rms <= ROW_TOL["rms"] and worst <= ROW_TOL["worst"]
    assert xg.grad.dtype == dt and wg.grad.dtype == dt
    rel = ((wg.grad.float() - dw.float()).norm() / dw.float().norm()).item()
    assert rel <= DW_TOL[dtype], rel


@pytest.mark.gpu
def test_rms_norm_backward_f32_weight_bf16_rows(cuda):
    """Mixed dtypes: dx in x's dtype, dw in w's."""
    x, w, dy = _inputs((64, 5120), 3)
    xg = torch.tensor(x, device=cuda).bfloat16().requires_grad_()
    wg = torch.tensor(w, device=cuda, requires_grad=True)
    rms_norm(xg, wg).backward(torch.tensor(dy, device=cuda).bfloat16())
    dx, dw = rms_norm_bwd_ref(xg.detach(), wg.detach(),
                              torch.tensor(dy, device=cuda).bfloat16())
    assert xg.grad.dtype == torch.bfloat16 and wg.grad.dtype == torch.float32
    np.testing.assert_allclose(xg.grad.float().cpu().numpy(),
                               dx.float().cpu().numpy(), **TOL["bfloat16"])
    rel = ((wg.grad - dw).norm() / dw.norm()).item()
    assert rel <= DW_TOL["float32"], rel


@pytest.mark.gpu
def test_rms_norm_without_grad_takes_the_plain_launch(cuda):
    """Serving (no grad) never records the Function nor stores rstd."""
    x = torch.randn(8, 256, device=cuda)
    w = torch.ones(256, device=cuda, requires_grad=True)
    with torch.no_grad():
        y = rms_norm(x, w)
    assert y.grad_fn is None
    torch.testing.assert_close(y, rms_norm_ref(x, w.detach()))


@pytest.mark.gpu
def test_guarded_wrappers_raise_under_grad_on_the_card(cuda):
    """Each forward-only CUDA wrapper refuses an input that requires grad
    (before any check of its shapes: the guard comes first)."""
    def t(*shape):
        return torch.randn(*shape, device=cuda, dtype=torch.bfloat16)

    table = torch.ones((1, 2), device=cuda, dtype=torch.int32)
    pos = torch.tensor([20], device=cuda, dtype=torch.int32)
    calls = {
        "flash_attention": lambda g: flash_attention(g, t(1, 64, 2, 64),
                                                     t(1, 64, 2, 64)),
        "paged_decode_attention": lambda g: paged_decode_attention(
            g, t(4, 16, 2, 64), t(4, 16, 2, 64), table, pos, page_size=16),
        "paged_mla_decode_attention": lambda g: paged_mla_decode_attention(
            g, t(1, 1, 4, 32), t(4, 16, 64), t(4, 16, 32), table, pos,
            page_size=16, scale=0.1),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=f"{name}.*no backward"):
            call(t(1, 1 if "decode" in name else 64, 4, 64)
                 .requires_grad_())
    # the SSD scan has its backward: under grad it runs as SSDScanFn
    x = t(1, 64, 4, 64).requires_grad_()
    y, _ = ssd_scan(x, torch.rand(1, 64, 4, device=cuda),
                    -torch.rand(4, device=cuda), t(1, 64, 4, 16),
                    t(1, 64, 4, 16), chunk=64)
    assert y.grad_fn is not None
    y.float().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad.float()).all()


def _ssd_model_case(shape, dtype, device, seed=4):
    """Inputs in the model's layout (``models/ssm.py`` at ssm_ngroups 1):
    x, B and C views of one conv output (B, S, H*P + 2N), B and C its one
    group expanded to every head (head stride 0); dt, a and that output
    are the leaves.  Returns (leaves, views(leaves), dy, dh_final)."""
    b, s, h, p, n, _ = shape
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((b, s, h * p + 2 * n), np.float32)
    conv[..., h * p:] *= 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1
    a = -np.exp(rng.standard_normal(h) * 0.3)
    dy = rng.standard_normal((b, s, h, p), np.float32)
    dhf = rng.standard_normal((b, h, p, n), np.float32)
    leaves = [torch.tensor(conv, device=device).to(dtype).requires_grad_(),
              torch.tensor(dt.astype(np.float32), device=device,
                           requires_grad=True),
              torch.tensor(a.astype(np.float32), device=device,
                           requires_grad=True)]

    def views(conv_t, dt_t, a_t):
        bc = conv_t[..., h * p:].unflatten(-1, (2, 1, n))
        return (conv_t[..., :h * p].unflatten(-1, (h, p)), dt_t, a_t,
                bc[:, :, 0].expand(b, s, h, n), bc[:, :, 1].expand(b, s, h, n))
    return (leaves, views, torch.tensor(dy, device=device).to(dtype),
            torch.tensor(dhf, device=device))


def _ssd_grads(scan, leaves, views, dy, dhf, chunk):
    y, hf = scan(*views(*leaves), chunk=chunk)
    return torch.autograd.grad((y, hf), leaves, (dy.to(y.dtype), dhf))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_BWD_SHAPES)
def test_ssd_backward_kernel_matches_plain(shape, dtype, cuda):
    """The scan's gradients through ``SSDScanFn`` (the backward kernel) in
    the model's layout against autograd through the plain scan in f32
    from the same inputs: d(conv) (so dx and the group's dB and dC), ddt
    and da; the launch counters move by one each."""
    dt = getattr(torch, dtype)
    leaves, views, dy, dhf = _ssd_model_case(shape, dt, cuda)
    f0, b0 = ssd_scan.launches.value, ssd_scan_bwd.launches.value
    got = _ssd_grads(ssd_scan, leaves, views, dy, dhf, shape[-1])
    torch.cuda.synchronize()
    assert ssd_scan.launches.value == f0 + 1
    assert ssd_scan_bwd.launches.value == b0 + 1
    plain = [t.detach().float().requires_grad_() for t in leaves]
    want = _ssd_grads(ssd_scan_ref, plain, views, dy.float(), dhf,
                      shape[-1])
    b, s, h, p, n, _ = shape
    for name, g, w in zip(("conv", "dt", "a"), got, want):
        assert g.dtype == leaves[("conv", "dt", "a").index(name)].dtype
        assert torch.isfinite(g.float()).all(), name
        if dtype == "float32":
            tol = SSD_BWD_TOL["rtol"] * w.abs() \
                + SSD_BWD_TOL["atol_of_max"] * w.abs().max()
            bad = (g - w).abs() > tol
            assert not bad.any(), (name, (g - w).abs().max().item())
            continue
        if name == "conv":      # dx rows (b, s, h), dB and dC rows (b, s)
            rows = [(g[..., :h * p].unflatten(-1, (h, p)),
                     w[..., :h * p].unflatten(-1, (h, p))),
                    (g[..., h * p:h * p + n], w[..., h * p:h * p + n]),
                    (g[..., h * p + n:], w[..., h * p + n:])]
        else:                   # ddt rows (b, s) over heads; da one row
            rows = [(g, w)]
        for gr, wr in rows:
            rms, worst = _row_rel(gr, wr)
            assert rms <= ROW_TOL["rms"] and worst <= ROW_TOL["worst"], (
                name, rms, worst)


@pytest.mark.gpu
def test_ssd_without_grad_takes_the_plain_launch(cuda):
    """Serving (no grad) never records the Function: one forward launch,
    no backward."""
    leaves, views, _, _ = _ssd_model_case((1, 128, 2, 64, 32, 32),
                                          torch.bfloat16, cuda)
    f0, b0 = ssd_scan.launches.value, ssd_scan_bwd.launches.value
    with torch.no_grad():
        y, _ = ssd_scan(*views(*leaves), chunk=32)
    assert y.grad_fn is None
    assert ssd_scan.launches.value == f0 + 1
    assert ssd_scan_bwd.launches.value == b0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 300, 3, 64, 128, 256),
                                   (1, 128, 2, 64, 32, 32),
                                   (4, 1024, 48, 64, 128, 256)])
def test_ssd_backward_cb_routes(shape, cuda):
    """bf16: the C B^T launch once per group against the plain phase
    (``ssd_cb_ref`` in f32 from the same bf16 inputs, its lower triangle
    within 1e-4 of its largest value: one f32 sum of N products in
    another order), and the per-head route (B and C each head's own copy,
    G = H) giving the group route's (stride-0 view, G = 1) five gradients
    bit for bit."""
    from repro_torch.kernels.ssd_chunk import (bwd_groups, ssd_bwd_cb,
                                               ssd_bwd_states, ssd_cb_ref)

    leaves, views, dy, dhf = _ssd_model_case(shape, torch.bfloat16, cuda)
    args = [t.detach() for t in views(*leaves)]
    per_head = args[:3] + [t.contiguous() for t in args[3:]]
    assert bwd_groups(*args[3:]) == 1
    assert bwd_groups(*per_head[3:]) == shape[2]
    chunk = shape[-1]
    for inputs in (args, per_head):
        scratch = ssd_bwd_states(*inputs, dy, dhf, chunk=chunk)
        got = ssd_bwd_cb(*inputs, dy, scratch, chunk=chunk).tril()
        want = ssd_cb_ref(*inputs[3:], chunk=chunk)     # f32 sums
        assert got.shape == want.shape
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
    group = ssd_scan_bwd(*args, dy, dhf, chunk=chunk)
    heads = ssd_scan_bwd(*per_head, dy, dhf, chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "da", "dB", "dC"), heads, group):
        assert torch.equal(g, w), name
