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
forward entry, tensor parallelism's gated norm in training; it too
replaces ``jax.grad`` of ``src/repro/models/layers.py:11`` (the
reference differentiates the whole row's norm; no Pallas call).  There
``y = x * rstd * w`` with ``rstd = rsqrt(ss / width + eps)``, ``ss`` the
row's sum of squares over every rank's columns and ``x`` this rank's, so
``dx = rstd * w*dy - x * rstd^3 * s / width`` with ``s`` the row term
``sum_j x_j w_j dy_j`` summed over every rank, and ``dw`` the sum over
rows of ``dy * x * rstd``.  The sum over ranks is the caller's
all-reduce (``ops.RMSNormRstdFn``), never inside a kernel, so the work
is two launches on either side of it:

* pass 1, ``rms_norm_dot_dw``, reads x and dy once: each row's ``s_loc``
  (f32), and, since ``rstd`` is given in the forward, the ``dw`` sum of
  its rows in registers, one f32 partial row of D a program;
* pass 2, ``rms_norm_dx_given``, after the all-reduce: dx for every row,
  and in the same launch a few programs sum pass 1's ``dw`` partials by
  column strips (the first ``n_strips`` programs: they start at once and
  are done long before the row tiles).  An atomic ticket that let pass
  1's last program sum them would serialise 0.8-1.6 MB of partials on
  one SM (some 10 us); ``atomic_add`` of the partials into dw would sum
  in a different order every run.

What bounds all of them: bytes, about one FLOP per byte.  The forward reads x
and writes y; the backward reads x, dy and w and writes dx (plus one f32
per row of rstd, and dw).  At decode the rows are few (one per live slot)
and a launch costs more than the bytes.  The given-statistic backward
reads x and dy twice; its bound counts them once, which the card reaches
only if pass 2 finds them in its 50 MB L2: at mamba2-780m's two-rank
shape x and dy of one rank are 25.2 MB (4096 x 1536 bf16 each) and the
all-reduce between the passes moves 16 KB.  From HBM both times its
floor is 5/3 of the bound.

Design: the whole row (D <= 8192) is one power-of-two block held in
registers, so each row is read once, reduced once and written once.
Forward: one program per row.  Backward: a grid of at most two programs
per SM, each walking a contiguous run of rows with w loaded once and a
register accumulator for its partial ``dw``; the partials ``(programs,
D)`` in f32 are summed by a second small launch, ``dw_sum`` — a few MB
beside the tens of MB of x, dy and dx.

The given-statistic backward (:func:`given_plan`): pass 1 is a
persistent grid (``per_sm`` programs an SM) whose program ``p`` takes the
tiles ``p, p + P, p + 2P, ...`` of ``rows`` rows x ``next_power_of_2(D)``
columns, its loop software-pipelined over ``stages`` tiles (``tl.range``:
the loads of the next tiles are in flight while one is reduced), so that
each SM has tens of KB of loads outstanding where one row at a time had
6 KB.  Pass 2 is a plain grid over tiles of ``rows2`` rows that walks
them in the reverse of pass 1's order: the tiles pass 1 read last are
read again first, from L2.  The loads carry L2 hints: pass 1's
``evict_last`` (x and dy are wanted again), pass 2's ``evict_first``
and a streaming store of dx (nothing is wanted again).  The launch
parameters (``GIVEN``) were tuned at the two shapes of the TP train
path by ``norm_tune.py``, with what they gave beside them.

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
                          r, d, rows_per_prog, BLOCK: tl.constexpr):
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
def given_kernels():
    """The given-statistic backward's two ``@triton.jit`` kernels (defined
    at first use): pass 1 before the caller's all-reduce of the row
    terms, pass 2 after it."""
    import triton
    import triton.language as tl

    @triton.jit
    def rms_norm_dot_dw(x_ptr, w_ptr, dy_ptr, rstd_ptr, s_ptr, dwp_ptr, r, d,
                        n_tiles, ROWS: tl.constexpr, BLOCK: tl.constexpr,
                        STAGES: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        cmask = cols < d
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for t in tl.range(pid, n_tiles, tl.num_programs(0),
                          num_stages=STAGES):
            rows = t * ROWS + tl.arange(0, ROWS)
            rmask = rows < r
            m = rmask[:, None] & cmask[None, :]
            off = rows.to(tl.int64)[:, None] * d + cols[None, :]
            # x and dy to stay in L2 for pass 2
            x = tl.load(x_ptr + off, mask=m, other=0.0,
                        eviction_policy="evict_last").to(tl.float32)
            dy = tl.load(dy_ptr + off, mask=m, other=0.0,
                         eviction_policy="evict_last").to(tl.float32)
            rstd = tl.load(rstd_ptr + rows, mask=rmask, other=0.0)
            xdy = x * dy
            tl.store(s_ptr + rows, tl.sum(xdy * w[None, :], axis=1),
                     mask=rmask)
            acc += tl.sum(xdy * rstd[:, None], axis=0)
        tl.store(dwp_ptr + pid.to(tl.int64) * d + cols, acc, mask=cmask)

    @triton.jit
    def rms_norm_dx_given(x_ptr, w_ptr, dy_ptr, rstd_ptr, s_ptr, dx_ptr,
                          dwp_ptr, dw_ptr, r, d, n_tiles, n_strips, n_part,
                          inv_width, ROWS: tl.constexpr, BLOCK: tl.constexpr,
                          BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        if pid < n_strips:
            # dw: pass 1's partial rows summed over one strip of columns
            # (names apart from the other branch's: Triton types a name
            # assigned in both branches of an ``if`` as one)
            scols = pid * BLOCK_C + tl.arange(0, BLOCK_C)
            smask = scols < d
            sacc = tl.zeros([BLOCK_C], dtype=tl.float32)
            for p0 in range(0, n_part, BLOCK_P):
                parts = p0 + tl.arange(0, BLOCK_P)
                pm = (parts[:, None] < n_part) & smask[None, :]
                sacc += tl.sum(tl.load(dwp_ptr + parts[:, None].to(tl.int64)
                                       * d + scols[None, :], mask=pm,
                                       other=0.0), axis=0)
            tl.store(dw_ptr + scols, sacc.to(dw_ptr.dtype.element_ty),
                     mask=smask)
        else:
            # dx: the row tiles pass 1 read last come first (from L2)
            t = n_tiles - 1 - (pid - n_strips)
            rows = t * ROWS + tl.arange(0, ROWS)
            rmask = rows < r
            cols = tl.arange(0, BLOCK)
            cmask = cols < d
            m = rmask[:, None] & cmask[None, :]
            off = rows.to(tl.int64)[:, None] * d + cols[None, :]
            # x and dy read for the last time, dx streamed out
            x = tl.load(x_ptr + off, mask=m, other=0.0,
                        eviction_policy="evict_first").to(tl.float32)
            dy = tl.load(dy_ptr + off, mask=m, other=0.0,
                         eviction_policy="evict_first").to(tl.float32)
            w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
            rstd = tl.load(rstd_ptr + rows, mask=rmask, other=0.0)
            c = tl.load(s_ptr + rows, mask=rmask, other=0.0) * rstd \
                * inv_width
            dx = (w[None, :] * dy - x * (rstd * c)[:, None]) \
                * rstd[:, None]
            tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=m,
                     cache_modifier=".cs")

    return rms_norm_dot_dw, rms_norm_dx_given


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


@functools.cache
def _sms(index):
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device):
    """The SMs of the card ``device`` names (asked once a card)."""
    import torch

    index = torch.device(device).index
    return _sms(torch.cuda.current_device() if index is None else index)


def programs(r, device):
    """The backward's grid: at most two programs per SM, at most one per
    row."""
    return max(1, min(r, 2 * sm_count(device)))


def launch_bwd(x2, w, dy2, rstd, dx, dw, partials):
    """x2, dy2, dx: (R, D) contiguous; w, dw: (D,); rstd: (R,) f32;
    ``partials``: (programs, D) f32 scratch."""
    import triton

    r, d = x2.shape
    n = partials.shape[0]
    rows_kernel, sum_kernel = bwd_kernels()
    block = triton.next_power_of_2(d)
    rows_kernel[(n,)](x2, w, dy2, rstd, dx, partials, r, d,
                      triton.cdiv(r, n), BLOCK=block,
                      num_warps=16 if block >= 4096 else _warps(block))
    # narrow column strips, so that the sum over the partials spreads over
    # some 160 programs at D 5120 (with 128-wide strips 40 programs waited
    # on their loads: 0.017 ms at 264 x 5120 on an H100)
    block_c = 32
    sum_kernel[(triton.cdiv(d, block_c),)](partials, dw, n, d, BLOCK_P=64,
                                           BLOCK_C=block_c, num_warps=4)


# The given-statistic backward's launch parameters: each pass's tile of
# rows (``rows``, ``rows2``: a power of two, ``tile`` bytes of x by
# default); pass 1's ``warps``, ``stages`` and ``per_sm`` (its programs an
# SM); pass 2's ``warps2``, and the columns (``strip``) and the partial
# rows a step (``block_p``) of its dw strip programs.  Tuned by
# ``norm_tune.py`` on an H100 80GB HBM3 at 700 W, bf16, over rotating
# inputs, at mamba2-780m's gated norm split over two ranks (4096, 1536)
# and over four (4096, 768).  At the first these values gave pass 1
# 0.0113 ms and pass 2 0.0084 (0.0121 with no pass 1 before it, x and dy
# from HBM); the best of 128 pass-1 configurations gave 0.0112 (the best
# at 1, 2, 4 and 8 warps 0.0112-0.0116) and of 24 pass-2 ones 0.0079.
# At the second they gave 0.0067 and 0.0058; the best pass 1, 0.0061 (2
# warps, 2 rows, 8 programs an SM), left 1056 partial rows that cost
# pass 2 0.0064.  One plan serves both.
GIVEN = dict(tile=8192, warps=4, stages=3, per_sm=2, warps2=4, strip=32,
             block_p=64)


def _rows_for(nbytes, block, elsize):
    rows = 1
    while 2 * rows * block * elsize <= nbytes:
        rows *= 2
    return rows


@functools.lru_cache(maxsize=64)
def _plan(r, d, elsize, sms, over):
    import triton

    block = triton.next_power_of_2(d)
    plan = dict(GIVEN, **dict(over))
    plan.setdefault("rows", _rows_for(plan["tile"], block, elsize))
    plan.setdefault("rows2", _rows_for(plan["tile"], block, elsize))
    plan.setdefault("programs", max(1, min(triton.cdiv(r, plan["rows"]),
                                           plan["per_sm"] * sms)))
    return plan


def given_plan(r, d, elsize, sms, **over):
    """The given-statistic backward's launch parameters for ``r`` rows of
    ``d`` columns of ``elsize`` bytes on a card of ``sms`` SMs: ``GIVEN``
    with each tile's ``rows`` and pass 1's ``programs``; ``over`` (the
    tuning script's) replaces any of them.  Made once a shape: callers do
    not change it."""
    return _plan(r, d, elsize, sms, tuple(sorted(over.items())))


def launch_dot(x2, w, dy2, rstd, s, partials, plan):
    """Pass 1.  x2, dy2: (R, D) contiguous; w: (D,); rstd: (R,) f32 (the
    forward's); ``s``: (R,) f32 output, each row's ``s_loc``;
    ``partials``: (``plan["programs"]``, D) f32 output, each program's
    ``dw`` sum."""
    import triton

    r, d = x2.shape
    dot_kernel, _ = given_kernels()
    dot_kernel[(partials.shape[0],)](
        x2, w, dy2, rstd, s, partials, r, d, triton.cdiv(r, plan["rows"]),
        ROWS=plan["rows"], BLOCK=triton.next_power_of_2(d),
        STAGES=plan["stages"], num_warps=plan["warps"])


def launch_dx(x2, w, dy2, rstd, s, width, dx, dw, partials, plan):
    """Pass 2.  ``s``: (R,) f32, the row terms summed over the whole row;
    ``width``: the whole row's width; dx: (R, D) output in x's dtype; dw:
    (D,) output in w's, the sum of pass 1's ``partials``."""
    import triton

    r, d = x2.shape
    _, dx_kernel = given_kernels()
    n_tiles = triton.cdiv(r, plan["rows2"])
    n_strips = triton.cdiv(d, plan["strip"])
    dx_kernel[(n_strips + n_tiles,)](
        x2, w, dy2, rstd, s, dx, partials, dw, r, d, n_tiles, n_strips,
        partials.shape[0], 1.0 / width, ROWS=plan["rows2"],
        BLOCK=triton.next_power_of_2(d), BLOCK_P=plan["block_p"],
        BLOCK_C=plan["strip"], num_warps=plan["warps2"])
