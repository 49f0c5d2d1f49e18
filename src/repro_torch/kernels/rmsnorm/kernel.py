"""RMSNorm in Triton for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/rmsnorm/kernel.py::
_kernel`` (launched by ``rms_norm_2d``, wrapped by ``ops.py::rms_norm``).

What it computes: per row, ``x * rsqrt(mean(x^2) + eps) * w`` with the
statistics in f32 and the output in x's dtype.

What bounds it: bytes — one read and one write of each row (plus the
weight, which stays in L2), about one FLOP per byte.  At decode the rows
are few (one per live slot) and a launch costs more than the bytes.

Design: one program per row; the whole row (D <= 8192) is one
power-of-two block held in registers, so the row is read once, reduced
once and written once — no second pass over device memory.

``triton`` is imported inside :func:`kernel`, never at module import, so
the CPU tests can import this module without it.
"""
from __future__ import annotations

import functools

MAX_D = 8192


@functools.cache
def kernel():
    """The ``@triton.jit`` kernel (defined at first use)."""
    import triton
    import triton.language as tl

    @triton.jit
    def rms_norm_rows(x_ptr, w_ptr, o_ptr, stride_x, stride_o, d, eps,
                      BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                    other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / d
        y = x * tl.math.rsqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(o_ptr + row * stride_o + cols,
                 (y * w).to(o_ptr.dtype.element_ty), mask=mask)

    return rms_norm_rows


def launch(x2, w, out, eps):
    """x2, out: (R, D) with unit column stride; w: (D,) contiguous."""
    import triton

    r, d = x2.shape
    block = triton.next_power_of_2(d)
    kernel()[(r,)](x2, w, out, x2.stride(0), out.stride(0), d, float(eps),
                   BLOCK=block, num_warps=8 if block >= 2048 else 4)
