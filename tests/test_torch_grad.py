"""Gradients through the port's kernels.

RMSNorm is the one kernel on the training path, and the only one with a
backward on the card (``kernels/rmsnorm``: ``RMSNormFn``, whose forward
is the Triton forward saving ``rstd`` and whose backward is the Triton
backward).  On the CPU its plain backward (``rms_norm_bwd_ref``) is held
to ``jax.grad`` of the reference's ``rms_norm``
(``src/repro/models/layers.py:11``) and to autograd through the plain
forward.  The other four CUDA wrappers have no backward: under autograd
they raise rather than hand back an output that carries no gradient
(``kernels.counter.forward_only``); on the CPU they take their plain
versions, which autograd differentiates.

The ``gpu`` cases hold the backward kernel to the plain backward on the
card and check that each guarded wrapper raises there; they skip here.

Tolerances.  CPU, f32: dx rtol 1e-5 / atol 1e-6 — XLA and PyTorch take
the row mean in another order.  Card: dx elementwise as the forward
kernel's (2e-5 in f32, 2e-2 in bf16; bf16 rows also held by
``ROW_TOL``), dw by its relative L2 error, 1e-5 in f32 (a sum over up
to 4096 rows in another order) and 2e-3 in bf16 (both round the same
f32 sums to bf16; an entry that rounds the other way is 2^-8 off, and
2e-3 allows some 6 % of entries to: ``chip_smoke.DW_TOL``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (flash_attention, paged_decode_attention,
                                 paged_mla_decode_attention, rms_norm,
                                 rms_norm_bwd, rms_norm_bwd_ref, rms_norm_ref,
                                 ssd_scan)
from repro_torch.kernels.counter import forward_only

SHAPES = [(128, 256), (4, 32, 512), (1, 64), (7, 5120)]
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DW_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
ROW_TOL = dict(rms=1e-2, worst=5e-2)


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
    with pytest.raises(NotImplementedError, match="item 17"):
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
        "ssd_scan": lambda g: ssd_scan(g, torch.rand(1, 64, 4, device=cuda),
                                       -torch.rand(4, device=cuda),
                                       t(1, 64, 4, 16), t(1, 64, 4, 16),
                                       chunk=64),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=f"{name}.*item 17"):
            call(t(1, 1 if "decode" in name else 64, 4, 64)
                 .requires_grad_())
