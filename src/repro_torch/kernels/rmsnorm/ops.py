"""Wrappers of the Triton RMSNorm kernels: any ``(..., D)`` shape.

``rms_norm`` is the forward; where autograd records it (grad mode on and
x or w requiring grad) it runs as ``RMSNormFn``, whose forward is the
same kernel storing each row's ``rstd`` and whose backward is
``rms_norm_bwd``, the backward kernel.  A CPU or meta tensor goes to
the plain version (``ref.py``), which autograd differentiates; a CUDA
tensor launches the kernel or raises — there is no fallback.  Under a
cost model (``counter.kernel_site``) each call is charged its kernel's
own work, and on the CPU or meta the plain versions run as
``RMSNormFn`` too, so that the backward is charged as the backward
kernel.

``rms_norm_rstd`` is the entry with each row's statistic given
(tensor parallelism's gated norm).  Under autograd it runs as
``RMSNormRstdFn`` on every device: its backward is ``rms_norm_dot`` (the
row term ``s_loc`` and the ``dw`` partials), the caller's ``reduce`` of
the row term (the all-reduce over the ranks that share the row), then
``rms_norm_bwd_rstd`` (dx given that term, and dw from pass 1's
partials): two launches; on the CPU and meta each takes its plain
version."""
from __future__ import annotations

import torch

from ..counter import PLAIN_DEVICES, LaunchCounter, cost_model, kernel_site
from .kernel import (MAX_D, given_plan, launch, launch_bwd, launch_dot,
                     launch_dx, programs, sm_count)
from .ref import (rms_norm_bwd_ref, rms_norm_bwd_rstd_ref, rms_norm_dot_ref,
                  rms_norm_ref, rms_norm_rstd_ref)

_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, w):
    if x.device.type != "cuda":
        raise RuntimeError(f"rms_norm: no kernel for device {x.device}")
    d = x.shape[-1]
    if d > MAX_D:
        raise ValueError(f"rms_norm kernel: D={d} exceeds {MAX_D}")
    if w.shape != (d,) or w.device != x.device:
        raise ValueError(f"weight {tuple(w.shape)} on {w.device} does not "
                         f"match x {tuple(x.shape)} on {x.device}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rms_norm kernel: dtypes {x.dtype}/{w.dtype}")
    x2 = x if x.dim() == 2 else x.reshape(-1, d)
    if x2.stride(-1) != 1:
        raise ValueError("rms_norm kernel: rows must be contiguous")
    return x2


def _forward(x2, w, eps, rstd=None):
    out = torch.empty(x2.shape, dtype=x2.dtype, device=x2.device)
    if x2.shape[0]:
        launch(x2, w.contiguous(), out, eps, rstd)
        rms_norm.launches.add()
    return out


def work(x, w, eps=1e-5):
    """(FLOPs, bytes) of a forward call: x read and the output written
    once, w read once."""
    return (4 * x.numel(), 2 * x.numel() * x.element_size()
            + w.numel() * w.element_size())


def bwd_work(x, w, dy, rstd, eps=1e-5):
    """(FLOPs, bytes) of a backward call: x, dy and w read, dx written."""
    return (9 * x.numel(), 3 * x.numel() * x.element_size()
            + w.numel() * w.element_size())


@kernel_site(work)
def rms_norm(x, w, eps=1e-5):
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.device.type in PLAIN_DEVICES:
        if grad and cost_model() is not None:
            return RMSNormFn.apply(x, w, eps)
        return rms_norm_ref(x, w, eps)
    x2 = _check(x, w)
    if grad:
        return RMSNormFn.apply(x2, w, eps).reshape(x.shape)
    return _forward(x2, w, eps).reshape(x.shape)


def rstd_work(x, w, rstd):
    """(FLOPs, bytes) of an ``rms_norm_rstd`` call: x and the rows'
    ``rstd`` read, the output written once, w read once."""
    return (2 * x.numel(), 2 * x.numel() * x.element_size()
            + w.numel() * w.element_size() + rstd.numel() * 4)


def _rows_of(rstd, x2, what):
    r2 = (rstd if rstd.dim() == 1 else rstd.reshape(-1)).float().contiguous()
    if r2.shape != (x2.shape[0],) or r2.device != x2.device:
        raise ValueError(f"{what}: row terms {tuple(rstd.shape)} do not "
                         f"match x {tuple(x2.shape)}")
    return r2


def _forward_rstd(x2, w, r2):
    out = torch.empty(x2.shape, dtype=x2.dtype, device=x2.device)
    if x2.shape[0]:
        launch(x2, w.contiguous(), out, 0.0, r2, load_rstd=True)
        rms_norm.launches.add()
    return out


@kernel_site(rstd_work)
def rms_norm_rstd(x, w, rstd, width=None, reduce=None):
    """The forward kernel's second entry: ``x * rstd * w`` per row with
    each row's statistic given (``rstd``: f32, x's shape without its last
    dim), where the row's sum of squares was all-reduced across
    tensor-parallel ranks first.  Counted as an ``rms_norm`` launch.  A
    CPU or meta tensor takes the plain version.  Where autograd records
    it, it runs as ``RMSNormRstdFn`` (on the CPU with the plain
    versions): ``width`` is the whole row's width (default x's last dim)
    and ``reduce`` sums each row's term ``s_loc`` over the ranks that hold
    the row's other columns (None: x holds the whole row).  The gradient
    does not flow into ``rstd``: the Function's ``dx`` carries the path
    through the statistic."""
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if grad:
        return RMSNormRstdFn.apply(x, w, rstd.detach(),
                                   width or x.shape[-1], reduce)
    if x.device.type in PLAIN_DEVICES:
        return rms_norm_rstd_ref(x, w, rstd)
    x2 = _check(x, w)
    return _forward_rstd(x2, w, _rows_of(rstd, x2, "rms_norm_rstd")
                         ).reshape(x.shape)


def dot_work(x, w, dy, rstd):
    """(FLOPs, bytes) of an ``rms_norm_dot`` call: x and dy read, w and
    the rows' ``rstd`` read once, one f32 per row written (the ``dw``
    partials, a few rows of D, not counted)."""
    rows = x.numel() // x.shape[-1]
    return (5 * x.numel(), 2 * x.numel() * x.element_size()
            + w.numel() * w.element_size() + 2 * rows * 4)


def _given(x, w, dy, rstd, what):
    """The given-statistic backward's operands on the card, checked once:
    x and dy as (R, D) contiguous in x's dtype (on the TP train path both
    already are: no copy), w contiguous, the rows' ``rstd`` as (R,)
    f32."""
    x2 = _check(x, w).contiguous()
    dy2 = dy if dy.shape == x2.shape else dy.reshape(x2.shape)
    return (x2, w.contiguous(), dy2.to(x2.dtype).contiguous(),
            _rows_of(rstd, x2, what))


def _plan(x2):
    return given_plan(x2.shape[0], x2.shape[1], x2.element_size(),
                      sm_count(x2.device))


def _dot(x2, w, dy2, r2):
    """Pass 1 on checked operands: (s, dw partials), counted."""
    plan = _plan(x2)
    s = torch.empty(x2.shape[0], dtype=torch.float32, device=x2.device)
    partials = torch.empty((plan["programs"], x2.shape[1]),
                           dtype=torch.float32, device=x2.device)
    if x2.shape[0]:
        launch_dot(x2, w, dy2, r2, s, partials, plan)
        rms_norm_dot.launches.add()
    return s, partials


def _dx(x2, w, dy2, r2, s2, width, partials):
    """Pass 2 on checked operands: (dx, dw), counted."""
    dx = torch.empty_like(x2)
    dw = torch.empty(x2.shape[1], dtype=w.dtype, device=w.device)
    if x2.shape[0] == 0:
        return dx, dw.zero_()
    launch_dx(x2, w, dy2, r2, s2, width, dx, dw, partials, _plan(x2))
    rms_norm_bwd_rstd.launches.add()
    return dx, dw


@kernel_site(dot_work)
def rms_norm_dot(x, w, dy, rstd):
    """The given-statistic backward's pass 1: ``(s, partials)``, each
    row's ``s_loc = sum_j x_j w_j dy_j`` in f32 (x's shape without its
    last dim) and the ``dw`` partials ``(P, D)`` in f32 whose sum over P
    is ``sum over rows of dy * x * rstd`` (P: the kernel's programs).  A
    CPU or meta tensor takes the plain version (P = 1)."""
    if x.device.type in PLAIN_DEVICES:
        return rms_norm_dot_ref(x, w, dy, rstd)
    s, partials = _dot(*_given(x, w, dy, rstd, "rms_norm_dot"))
    return s.reshape(x.shape[:-1]), partials


def bwd_rstd_work(x, w, dy, rstd, s, width, partials):
    """(FLOPs, bytes) of an ``rms_norm_bwd_rstd`` call: x and dy read, dx
    written, w read and dw written, the two row terms read (the partials
    summed into dw not counted)."""
    return (6 * x.numel(), 3 * x.numel() * x.element_size()
            + 2 * w.numel() * w.element_size() + 2 * rstd.numel() * 4)


@kernel_site(bwd_rstd_work)
def rms_norm_bwd_rstd(x, w, dy, rstd, s, width, partials):
    """The given-statistic backward's pass 2: ``(dx, dw)`` of
    ``rms_norm_rstd(x, w, rstd)`` for ``dy``, where ``rstd = rsqrt(ss /
    width + eps)`` over the whole row, ``s`` is the row term summed over
    the whole row (``rms_norm_dot``'s of every part, added) and
    ``partials`` is pass 1's ``dw`` partials, summed here.  dx in x's
    dtype, dw in w's.  A CPU or meta tensor takes the plain version."""
    if x.device.type in PLAIN_DEVICES:
        return rms_norm_bwd_rstd_ref(x, w, dy, rstd, s, width, partials)
    x2, w2, dy2, r2 = _given(x, w, dy, rstd, "rms_norm_bwd_rstd")
    if partials.dim() != 2 or partials.shape[1] != x2.shape[1] \
            or partials.dtype != torch.float32 \
            or partials.device != x2.device:
        raise ValueError(f"rms_norm_bwd_rstd: dw partials "
                         f"{tuple(partials.shape)} {partials.dtype} do not "
                         f"match x {tuple(x2.shape)}")
    dx, dw = _dx(x2, w2, dy2, r2, _rows_of(s, x2, "rms_norm_bwd_rstd"),
                 width, partials.contiguous())
    return dx.reshape(x.shape), dw


class RMSNormRstdFn(torch.autograd.Function):
    """``rms_norm_rstd`` under autograd: the forward entry given the
    rows' statistic; the backward ``rms_norm_dot`` (pass 1), ``reduce``
    (the caller's sum over the ranks: never inside a kernel), then
    ``rms_norm_bwd_rstd`` (pass 2).  On the card the operands are checked
    once for both passes; on the CPU and meta the plain versions."""

    @staticmethod
    def forward(ctx, x, w, rstd, width, reduce):
        if x.device.type in PLAIN_DEVICES:
            out = rms_norm_rstd_ref(x, w, rstd)
        else:
            x2 = _check(x, w)
            out = _forward_rstd(x2, w, _rows_of(rstd, x2, "rms_norm_rstd")
                                ).reshape(x.shape)
        ctx.save_for_backward(x, w, rstd)
        ctx.width, ctx.reduce = width, reduce
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd = ctx.saved_tensors
        reduce = ctx.reduce or (lambda t: t)
        if x.device.type in PLAIN_DEVICES:
            s, partials = rms_norm_dot(x, w, dy, rstd)
            dx, dw = rms_norm_bwd_rstd(x, w, dy, rstd, reduce(s), ctx.width,
                                       partials)
        else:
            ops = _given(x, w, dy, rstd, "rms_norm_rstd backward")
            s, partials = _dot(*ops)
            s = _rows_of(reduce(s.reshape(x.shape[:-1])), ops[0],
                         "rms_norm_rstd backward")
            dx, dw = _dx(*ops, s, ctx.width, partials)
            dx = dx.reshape(x.shape)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None, None, None)


@kernel_site(bwd_work)
def rms_norm_bwd(x, w, dy, rstd, eps=1e-5):
    """The backward kernel: ``(dx, dw)`` of ``rms_norm(x, w)`` for the
    output gradient ``dy``, with ``rstd`` (f32, one per row of x) from the
    forward.  x, dy: (..., D) on the card; dx in x's dtype, dw in w's.  A
    CPU or meta tensor takes the plain backward, which recomputes rstd
    from ``eps``."""
    if x.device.type in PLAIN_DEVICES:
        return rms_norm_bwd_ref(x, w, dy, eps)
    x2 = _check(x, w).contiguous()
    d = x2.shape[1]
    dy2 = dy.reshape(-1, d).to(x2.dtype).contiguous()
    if dy2.shape != x2.shape or rstd.shape != (x2.shape[0],) \
            or rstd.dtype != torch.float32:
        raise ValueError(f"rms_norm_bwd: dy {tuple(dy.shape)} / rstd "
                         f"{tuple(rstd.shape)} {rstd.dtype} do not match x "
                         f"{tuple(x.shape)}")
    dx = torch.empty_like(x2)
    dw = torch.empty(d, dtype=w.dtype, device=w.device)
    r = x2.shape[0]
    if r == 0:
        return dx.reshape(x.shape), dw.zero_()
    partials = torch.empty((programs(r, x2.device), d), dtype=torch.float32,
                           device=x2.device)
    launch_bwd(x2, w.contiguous(), dy2, rstd.contiguous(), dx, dw, partials)
    rms_norm_bwd.launches.add()
    return dx.reshape(x.shape), dw


class RMSNormFn(torch.autograd.Function):
    """RMSNorm under autograd on the card: the forward kernel (saving
    ``rstd``), the backward kernel for its gradient.  Under a cost model
    on the CPU or meta, the plain forward and backward in their place."""

    @staticmethod
    def forward(ctx, x2, w, eps):
        if x2.device.type in PLAIN_DEVICES:
            out, rstd = rms_norm_ref(x2, w, eps), None
        else:
            rstd = torch.empty(x2.shape[0], dtype=torch.float32,
                               device=x2.device)
            out = _forward(x2, w, eps, rstd)
        ctx.save_for_backward(x2, w, rstd)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dy):
        x2, w, rstd = ctx.saved_tensors
        if rstd is None:        # the plain forward: rstd from eps
            dx, dw = rms_norm_bwd(x2, w, dy, None, eps=ctx.eps)
        else:
            dx, dw = rms_norm_bwd(x2, w, dy, rstd)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None)


rms_norm.launches = LaunchCounter()
rms_norm_bwd.launches = LaunchCounter()
rms_norm_dot.launches = LaunchCounter()
rms_norm_bwd_rstd.launches = LaunchCounter()
