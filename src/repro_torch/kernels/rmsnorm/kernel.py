"""RMSNorm in Triton for Hopper: the forward and its gradient.

Forward — replaces the Pallas TPU kernel ``src/repro/kernels/rmsnorm/
kernel.py::_kernel`` (launched by ``rms_norm_2d``, wrapped by
``ops.py::rms_norm``).  Per row, ``x * rsqrt(mean(x^2) + eps) * w`` with
the statistics in f32 and the output in x's dtype; under autograd it also
stores each row's ``rstd`` (f32) for the backward.  A second entry
(``LOAD_RSTD``) takes each row's ``rstd`` as an input instead of
computing it: tensor parallelism's gated norm, whose rows are split
across ranks and whose statistic is all-reduced first.

Backward — replaces the reference's gradient of ``src/repro/models/
layers.py:11`` ``rms_norm`` (``jax.grad`` of the jnp function; no Pallas
call of the reference has a VJP).  With ``xh = x * rstd``:
``dx = rstd * (w*dy - xh * mean(xh*w*dy))`` per row, and
``dw = sum over rows of dy*xh``, in f32; dx in x's dtype, dw in w's.

Backward with the row statistic given — the gradient of the second
forward entry, tensor parallelism's gated norm in training.  There
``y = x * rstd * w`` with ``rstd = rsqrt(ss / width + eps)``, ``ss`` the
row's sum of squares over every rank's columns and ``x`` this rank's.
Two entries: ``rms_norm_dot_rows`` stores each row's
``s_loc = sum_j x_j w_j dy_j`` in f32; the caller all-reduces it over
the ranks (``ops.RMSNormRstdFn``, never in the kernel); then the backward
kernel with ``LOAD_DOT`` takes that row term in place of its own mean:
``dx = rstd * (w*dy) - x * rstd^3 * s / width`` and the ``dw`` partials
as above.

What bounds all of them: bytes, about one FLOP per byte.  The forward reads x
and writes y; the backward reads x, dy and w and writes dx (plus one f32
per row of rstd, and dw).  At decode the rows are few (one per live slot)
and a launch costs more than the bytes.

Design: the whole row (D <= 8192) is one power-of-two block held in
registers, so each row is read once, reduced once and written once.
Forward: one program per row.  Backward: a grid of at most two programs
per SM, each walking a contiguous run of rows with w loaded once and a
register accumulator for its partial ``dw``; the partials ``(programs,
D)`` in f32 are summed by a second small launch, ``dw_sum`` — a few MB
beside the tens of MB of x, dy and dx.

``triton`` is imported inside :func:`kernel`, never at module import, so
the CPU tests can import this module without it.
"""
from __future__ import annotations

import functools

MAX_D = 8192


@functools.cache
def kernel():
    """The forward ``@triton.jit`` kernel (defined at first use)."""
    import triton
    import triton.language as tl

    @triton.jit
    def rms_norm_rows(x_ptr, w_ptr, o_ptr, rstd_ptr, stride_x, stride_o, d,
                      eps, BLOCK: tl.constexpr, STORE_RSTD: tl.constexpr,
                      LOAD_RSTD: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                    other=0.0).to(tl.float32)
        if LOAD_RSTD:
            rstd = tl.load(rstd_ptr + row)
        else:
            var = tl.sum(x * x, axis=0) / d
            rstd = tl.math.rsqrt(var + eps)
        y = x * rstd
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(o_ptr + row * stride_o + cols,
                 (y * w).to(o_ptr.dtype.element_ty), mask=mask)
        if STORE_RSTD:
            tl.store(rstd_ptr + row, rstd)

    return rms_norm_rows


@functools.cache
def bwd_kernels():
    """The backward's two ``@triton.jit`` kernels (defined at first use):
    ``dx`` plus per-program partial ``dw`` rows, then the column sum."""
    import triton
    import triton.language as tl

    @triton.jit
    def rms_norm_bwd_rows(x_ptr, w_ptr, dy_ptr, rstd_ptr, dx_ptr, dwp_ptr,
                          s_ptr, r, d, inv_width, rows_per_prog,
                          BLOCK: tl.constexpr, LOAD_DOT: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        start = pid * rows_per_prog
        end = tl.minimum(start + rows_per_prog, r)
        for row in range(start, end):
            off = row.to(tl.int64) * d
            x = tl.load(x_ptr + off + cols, mask=mask,
                        other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + off + cols, mask=mask,
                         other=0.0).to(tl.float32)
            rstd = tl.load(rstd_ptr + row)
            xh = x * rstd
            wdy = w * dy
            if LOAD_DOT:        # the row term given: sum over all ranks
                c = tl.load(s_ptr + row) * rstd * inv_width
            else:
                c = tl.sum(xh * wdy, axis=0) / d
            dx = (wdy - xh * c) * rstd
            tl.store(dx_ptr + off + cols, dx.to(dx_ptr.dtype.element_ty),
                     mask=mask)
            acc += dy * xh
        tl.store(dwp_ptr + pid.to(tl.int64) * d + cols, acc, mask=mask)

    @triton.jit
    def dw_sum(dwp_ptr, dw_ptr, n_part, d, BLOCK_P: tl.constexpr,
               BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < d
        acc = tl.zeros([BLOCK_C], dtype=tl.float32)
        for p0 in range(0, n_part, BLOCK_P):
            parts = p0 + tl.arange(0, BLOCK_P)
            m = (parts[:, None] < n_part) & cmask[None, :]
            acc += tl.sum(tl.load(dwp_ptr + parts[:, None].to(tl.int64) * d
                                  + cols[None, :], mask=m, other=0.0),
                          axis=0)
        tl.store(dw_ptr + cols, acc.to(dw_ptr.dtype.element_ty), mask=cmask)

    return rms_norm_bwd_rows, dw_sum


@functools.cache
def dot_kernel():
    """The given-statistic backward's row term (defined at first use):
    ``sum_j x_j w_j dy_j`` per row in f32, one program per row."""
    import triton
    import triton.language as tl

    @triton.jit
    def rms_norm_dot_rows(x_ptr, w_ptr, dy_ptr, s_ptr, d,
                          BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        x = tl.load(x_ptr + row * d + cols, mask=mask,
                    other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + row * d + cols, mask=mask,
                     other=0.0).to(tl.float32)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(s_ptr + row, tl.sum(x * w * dy, axis=0))

    return rms_norm_dot_rows


def _warps(block):
    return 8 if block >= 2048 else 4


def launch(x2, w, out, eps, rstd=None, load_rstd=False):
    """x2, out: (R, D) with unit column stride; w: (D,) contiguous;
    ``rstd``: an (R,) f32 buffer to store each row's ``rstd`` in, or
    None; with ``load_rstd`` the rows' given ``rstd`` (``eps`` unused)."""
    import triton

    r, d = x2.shape
    block = triton.next_power_of_2(d)
    kernel()[(r,)](x2, w, out, out if rstd is None else rstd, x2.stride(0),
                   out.stride(0), d, float(eps), BLOCK=block,
                   STORE_RSTD=rstd is not None and not load_rstd,
                   LOAD_RSTD=load_rstd, num_warps=_warps(block))


def programs(r, device):
    """The backward's grid: at most two programs per SM, at most one per
    row."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(r, 2 * sms))


def launch_dot(x2, w, dy2, s):
    """x2, dy2: (R, D) contiguous; w: (D,); ``s``: (R,) f32 output."""
    import triton

    r, d = x2.shape
    block = triton.next_power_of_2(d)
    dot_kernel()[(r,)](x2, w, dy2, s, d, BLOCK=block,
                       num_warps=_warps(block))


def launch_bwd(x2, w, dy2, rstd, dx, dw, partials, s=None, width=None):
    """x2, dy2, dx: (R, D) contiguous; w, dw: (D,); rstd: (R,) f32;
    ``partials``: (programs, D) f32 scratch; ``s`` (R,) f32 and
    ``width``: the row term and the row's whole width given (the
    ``LOAD_DOT`` entry), or None."""
    import triton

    r, d = x2.shape
    n = partials.shape[0]
    rows_kernel, sum_kernel = bwd_kernels()
    block = triton.next_power_of_2(d)
    rows_kernel[(n,)](x2, w, dy2, rstd, dx, partials,
                      rstd if s is None else s, r, d,
                      1.0 / (width or d), triton.cdiv(r, n),
                      BLOCK=block, LOAD_DOT=s is not None,
                      num_warps=16 if block >= 4096 else _warps(block))
    # narrow column strips, so that the sum over the partials spreads over
    # some 160 programs at D 5120 (with 128-wide strips 40 programs waited
    # on their loads: 0.017 ms at 264 x 5120 on an H100)
    block_c = 32
    sum_kernel[(triton.cdiv(d, block_c),)](partials, dw, n, d, BLOCK_P=64,
                                           BLOCK_C=block_c, num_warps=4)
