"""Plain PyTorch RMSNorm — the math of ``repro/models/layers.py::rms_norm``
(the Pallas kernel's oracle): statistics in f32, output in x's dtype —
and its gradient written out, the backward kernels' plain versions."""
from __future__ import annotations

import torch


def rms_norm_ref(x, w, eps=1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def rms_norm_rstd_ref(x, w, rstd):
    """``rms_norm_ref`` with each row's ``rstd`` given (f32, x's shape
    without its last dim) instead of computed: ``x * rstd * w`` in f32,
    the output in x's dtype."""
    y = x.float() * rstd.float()[..., None]
    return (y * w.float()).to(x.dtype)


def rms_norm_bwd_ref(x, w, dy, eps=1e-5):
    """``(dx, dw)`` of ``rms_norm_ref(x, w, eps)`` for the output gradient
    ``dy``, in f32: with ``xh = x * rstd``, ``dx = rstd * (w*dy - xh *
    mean(xh*w*dy))`` per row and ``dw`` the sum of ``dy*xh`` over rows;
    dx in x's dtype, dw in w's."""
    x32 = x.float()
    rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    xh = x32 * rstd
    wdy = w.float() * dy.float()
    dx = rstd * (wdy - xh * (xh * wdy).mean(dim=-1, keepdim=True))
    dw = (dy.float() * xh).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def rms_norm_dot_ref(x, w, dy, rstd, parts=1):
    """The given-statistic backward's pass 1: ``(s, partials)``, each
    row's term ``sum_j x_j w_j dy_j`` in f32 (x's shape without its last
    dim) and the ``dw`` partials ``(parts, D)`` in f32, part ``p`` the sum
    of ``dy * x * rstd`` over rows ``p, p + parts, ...`` (the kernel's
    programs each sum their own rows so)."""
    x32, dy32 = x.float(), dy.float()
    s = (x32 * w.float() * dy32).sum(dim=-1)
    d = x.shape[-1]
    g = (dy32 * x32 * rstd.float()[..., None]).reshape(-1, d)
    g = torch.cat([g, g.new_zeros((-g.shape[0]) % parts, d)])
    return s, g.reshape(-1, parts, d).sum(dim=0)


def rms_norm_bwd_rstd_ref(x, w, dy, rstd, s, width, partials):
    """Pass 2: ``(dx, dw)`` of ``rms_norm_rstd_ref(x, w, rstd)`` where
    ``rstd = rsqrt(ss / width + eps)`` and ``ss`` sums the squares of the
    whole row, of which x holds some columns: ``s`` is the row term
    summed over the whole row (``rms_norm_dot_ref`` of every part, added)
    and ``partials`` pass 1's ``dw`` partials.  In f32: ``dx = rstd *
    w*dy - x * rstd^3 * s / width``, ``dw`` the partials' sum; dx in x's
    dtype, dw in w's."""
    x32 = x.float()
    r = rstd.float()[..., None]
    dx = r * (w.float() * dy.float()) - x32 * r.pow(3) * (
        s.float()[..., None] / width)
    return dx.to(x.dtype), partials.sum(dim=0).to(w.dtype)
