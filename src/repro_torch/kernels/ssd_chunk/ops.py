"""Wrappers of the SSD chunk-scan kernels (``csrc/ssd_chunk.cu``, and its
backward ``csrc/ssd_chunk_bwd.cu``), in the (B, S, H, ...) layout of
``repro/kernels/ssd_chunk/ops.py::ssd_scan``.

A CPU or meta tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel on the current stream or raises — there is no
fallback.  The kernel reads x, dt, B and C through their strides (B and C
may be a head-broadcast view of stride 0: read once per group) and writes
y in (B, S, H, P), so the wrapper copies nothing.  In bf16 the scan is
three launches (chunk states, state pass, chunk output) on one f32
scratch; its design note is at the top of its source.

Under autograd on the card (grad mode on, an input requiring grad) the
scan runs as ``SSDScanFn``: the same forward launch, and ``ssd_scan_bwd``,
the backward kernel, for its gradient.  dB and dC come back per head, so
that where B and C are one group's stride-0 view (``models/ssm.py``)
autograd's expand backward sums the group's heads once.

Under a cost model (``counter.kernel_site``) each call is charged its
kernel's own work (``work``, ``bwd_work``), and on the CPU or meta the
plain versions run as ``SSDScanFn`` too, so that the backward is charged
as the backward kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load_library
from ..counter import PLAIN_DEVICES, LaunchCounter, cost_model, kernel_site
from .ref import bwd_groups, ssd_scan_bwd_ref, ssd_scan_ref

SOURCES = ["ssd_chunk.cu"]
BWD_SOURCES = ["ssd_chunk_bwd.cu"]
MAX_HEAD_DIM = 64
MAX_STATE = 128
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# phases of the bf16 scan (a bit mask of the C entry)
STATES, PASS, OUTPUT = 1, 2, 4
# phases of the backward: the states, the forward's state pass and the
# reverse pass (h_prev, h_final, the state gradients); the within-chunk
# gradients from them; and, in bf16, C B^T once per (batch, chunk, group),
# which the within-chunk gradients read
BWD_STATES, BWD_GRADS, BWD_CB = 1, 2, 4
# the bf16 backward's launches, in order (``bwd_plan``)
BWD_LAUNCHES = ("states", "pass", "cb", "rows", "cols", "dcum")


def library() -> ctypes.CDLL:
    """The built kernel library (``nvcc`` at first use)."""
    lib = load_library("ssd_chunk", SOURCES)
    fn = lib.repro_ssd_chunk_scan
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i] + [p] * 9 + [i] * 6 + [ll] * 12 + [p]
        fn.restype = i
    return lib


def _check(x, dt, a, bmat, cmat, chunk):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    if dt.shape != (b, s, h) or a.shape != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} / a {tuple(a.shape)} do "
                         f"not match x {tuple(x.shape)}")
    if bmat.dim() != 4 or bmat.shape[:3] != (b, s, h) \
            or cmat.shape != bmat.shape:
        raise ValueError(f"B {tuple(bmat.shape)} / C {tuple(cmat.shape)} "
                         f"do not match x {tuple(x.shape)}")
    n = bmat.shape[3]
    if not (0 < p <= MAX_HEAD_DIM and 0 < n <= MAX_STATE):
        raise ValueError(f"head dim {p} / state {n} exceed "
                         f"{MAX_HEAD_DIM} / {MAX_STATE}")
    if s == 0 or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"sequence {s} / chunk {chunk}: need S > 0 and a "
                         f"chunk in [1, {MAX_CHUNK}]")
    if x.dtype not in _DTYPES or bmat.dtype != x.dtype \
            or cmat.dtype != x.dtype:
        raise TypeError(f"dtypes {x.dtype}/{bmat.dtype}/{cmat.dtype}: need "
                        "matching float32 or bfloat16")
    for name, t in (("dt", dt), ("a", a), ("bmat", bmat), ("cmat", cmat)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("bmat", bmat), ("cmat", cmat)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last axis must be unit-stride")
        # bf16 rows arrive by 16-byte copies
        if x.dtype == torch.bfloat16 and (
                t.shape[3] % 8 or t.data_ptr() % 16
                or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"bf16 {name}: need its last axis a multiple "
                             "of 8 and 16-byte aligned rows")


def _launch(phases, dtype, dims, chunk, *, x=None, dt=None, a=None,
            bmat=None, cmat=None, y=None, hf=None, states=None, decay=None):
    """One call of the C entry; absent tensors go in as null pointers."""
    def ptr(t):
        return 0 if t is None else t.data_ptr()

    def strides(t):
        return (0, 0, 0) if t is None else t.stride()[:3]
    dev = (x if x is not None else states).device
    err = library().repro_ssd_chunk_scan(
        _DTYPES[dtype], phases, ptr(x), ptr(dt), ptr(a), ptr(bmat),
        ptr(cmat), ptr(y), ptr(hf), ptr(states), ptr(decay), *dims,
        int(chunk), *strides(x), *strides(dt), *strides(bmat),
        *strides(cmat), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error "
                           f"{err}")


def _scratch(b, h, nc, p, n, device):
    """f32 scratch of the bf16 scan: states (B, H, nc, P, N), then the
    chunks' cum_last (B, H, nc)."""
    buf = torch.empty(b * h * nc * (p * n + 1), dtype=torch.float32,
                      device=device)
    return (buf[:b * h * nc * p * n].view(b, h, nc, p, n),
            buf[b * h * nc * p * n:].view(b, h, nc))


def _prepare(x, dt, a, bmat, cmat, chunk):
    _check(x, dt, a, bmat, cmat, chunk)
    b, s, h, p = x.shape
    dims = (b, s, h, p, bmat.shape[3])
    return dt.float(), a.float().contiguous(), dims


def _chunk_sizes(s, chunk):
    return [min(chunk, s - c0) for c0 in range(0, s, chunk)]


def _in_bytes(x, dt, a, bmat, cmat):
    """x, dt and a, and B and C once per group (``bwd_groups``)."""
    b, s, h, p = x.shape
    g, n = bwd_groups(bmat, cmat), bmat.shape[3]
    return (x.numel() * x.element_size() + dt.numel() * dt.element_size()
            + a.numel() * a.element_size() + 2 * b * s * g * n
            * bmat.element_size())


def work(x, dt, a, bmat, cmat, *, chunk=256):
    """(FLOPs, bytes) of a forward call: per chunk of q positions and per
    head, the masked products C B^T and M X on the lower triangle and
    the chunk state and its output (P N each, twice); the inputs read
    once, y and h_final written once."""
    b, s, h, p = x.shape
    n = bmat.shape[3]
    flops = sum(2 * b * h * (q * (q + 1) // 2 * (n + p) + 2 * q * p * n)
                for q in _chunk_sizes(s, chunk))
    return flops, (_in_bytes(x, dt, a, bmat, cmat) + x.numel()
                   * x.element_size() + b * h * p * n * 4)


def bwd_work(x, dt, a, bmat, cmat, dy, dh_final=None, *, chunk=256):
    """(FLOPs, bytes) of a backward call: per chunk and head dY X^T, Z B,
    Z^T C and M^T dY on the lower triangle, five whole P N products, and
    C B^T once per group; x, dt, a, B, C and dy read once, dx, ddt, da
    and the group's dB and dC written once."""
    b, s, h, p = x.shape
    g, n = bwd_groups(bmat, cmat), bmat.shape[3]
    flops = 0
    for q in _chunk_sizes(s, chunk):
        tri = q * (q + 1) // 2
        flops += 2 * b * (h * (tri * (2 * n + 2 * p) + 5 * q * p * n)
                          + g * tri * n)
    return flops, 2 * _in_bytes(x, dt, a, bmat, cmat) + dy.numel() \
        * dy.element_size()


@kernel_site(work)
def ssd_scan(x, dt, a, bmat, cmat, *, chunk=256):
    """x: (B, S, H, P); dt: (B, S, H) step sizes; a: (H,) negative decay
    rates; b/c: (B, S, H, N).  Returns (y: (B, S, H, P) in x's dtype,
    h_final: (B, H, P, N) f32) — the chunked SSD scan from a zero state.
    Under autograd on the card it runs as ``SSDScanFn``."""
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, a, bmat, cmat))
    if x.device.type in PLAIN_DEVICES:
        if grad and cost_model() is not None:
            return SSDScanFn.apply(x, dt, a, bmat, cmat, chunk)
        return ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk)
    if x.device.type != "cuda":
        raise RuntimeError(f"ssd_scan: no kernel for device {x.device}")
    if grad:
        return SSDScanFn.apply(x, dt, a, bmat, cmat, chunk)
    return _scan(x, dt, a, bmat, cmat, chunk)


def _scan(x, dt, a, bmat, cmat, chunk):
    """The forward launch (all three phases), counted."""
    dt, a, dims = _prepare(x, dt, a, bmat, cmat, chunk)
    b, s, h, p, n = dims
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    hf = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    states = decay = None
    if x.dtype == torch.bfloat16:
        states, decay = _scratch(b, h, -(-s // chunk), p, n, x.device)
    _launch(STATES | PASS | OUTPUT, x.dtype, dims, chunk, x=x, dt=dt, a=a,
            bmat=bmat, cmat=cmat, y=y, hf=hf, states=states, decay=decay)
    ssd_scan.launches.add()     # one per call: all three phases
    return y, hf


ssd_scan.launches = LaunchCounter()


# The bf16 scan's phases one at a time (CUDA tensors), for holding each to
# its plain version in ``ref.py`` and for planting faults between them;
# these launches are not counted.
def ssd_chunk_states(x, dt, a, bmat, cmat, *, chunk):
    """Phase 1: (states (B, H, nc, P, N) f32, each chunk's own
    contribution S_c; decay (B, H, nc) f32, each chunk's cum_last)."""
    dt, a, dims = _prepare(x, dt, a, bmat, cmat, chunk)
    b, s, h, p, n = dims
    states, decay = _scratch(b, h, -(-s // chunk), p, n, x.device)
    _launch(STATES, x.dtype, dims, chunk, x=x, dt=dt, a=a, bmat=bmat,
            cmat=cmat, states=states, decay=decay)
    return states, decay


def ssd_state_pass(states, decay):
    """Phase 2, in place: ``states`` becomes the state entering each chunk
    (h_prev).  Returns (h_prev, h_final (B, H, P, N) f32)."""
    b, h, nc, p, n = states.shape
    if not (states.is_cuda and states.is_contiguous() and decay.is_contiguous()
            and decay.shape == (b, h, nc) and states.dtype == torch.float32
            and decay.dtype == torch.float32):
        raise ValueError("states / decay must be contiguous f32 CUDA "
                         "tensors (B, H, nc, P, N) / (B, H, nc)")
    hf = torch.empty((b, h, p, n), dtype=torch.float32, device=states.device)
    # the pass reads no activations: S = nc chunks of one position
    _launch(PASS, torch.bfloat16, (b, nc, h, p, n), 1, hf=hf,
            states=states, decay=decay)
    return states, hf


def ssd_chunk_output(x, dt, a, bmat, cmat, h_prev, *, chunk):
    """Phase 3: y (B, S, H, P) in x's dtype from the states entering each
    chunk, ``h_prev`` (B, H, nc, P, N) f32 contiguous."""
    dt, a, dims = _prepare(x, dt, a, bmat, cmat, chunk)
    b, s, h, p, n = dims
    if h_prev.shape != (b, h, -(-s // chunk), p, n) \
            or h_prev.dtype != torch.float32 or not h_prev.is_contiguous():
        raise ValueError(f"h_prev {tuple(h_prev.shape)} does not match")
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    _launch(OUTPUT, x.dtype, dims, chunk, x=x, dt=dt, a=a, bmat=bmat,
            cmat=cmat, y=y, states=h_prev)
    return y


# ------------------------------------------------------------------ backward
def bwd_library() -> ctypes.CDLL:
    """The built backward library (``nvcc`` at first use)."""
    lib = load_library("ssd_chunk_bwd", BWD_SOURCES)
    fn = lib.repro_ssd_chunk_bwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i] + [p] * 18 + [i] * 7 + [ll] * 15 + [p]
        fn.restype = i
        plan = lib.repro_ssd_chunk_bwd_plan
        plan.argtypes = [i] * 7 + [p]
        plan.restype = i
    return lib


def _scratch_shapes(x, bmat, cmat, chunk):
    """The backward's f32 scratch: hprev and dstate (B, H, nc, P, N), hf
    (B, H, P, N), decay (B, H, nc), dcum (B, H, S); in bf16 also cb (B, nc,
    G, T, T), C B^T once per group, T the chunk rounded up to 64."""
    b, s, h, p = x.shape
    n, nc, t = bmat.shape[3], -(-s // chunk), -(-chunk // 64) * 64
    return dict(hprev=(b, h, nc, p, n), dstate=(b, h, nc, p, n),
                hf=(b, h, p, n), decay=(b, h, nc), dcum=(b, h, s),
                cb=((b, nc, bwd_groups(bmat, cmat), t, t)
                    if x.dtype == torch.bfloat16 else None))


def _bwd_scratch(x, bmat, cmat, chunk):
    return {k: None if shape is None else
            torch.empty(shape, dtype=torch.float32, device=x.device)
            for k, shape in _scratch_shapes(x, bmat, cmat, chunk).items()}


def _launch_bwd(phases, x, dt, a, bmat, cmat, dy, dims, chunk, scratch, *,
                dh_final=None, grads=None):
    """One call of the backward's C entry; ``grads``: (dx, ddt, da, dB,
    dC), absent without the within-chunk phase."""
    def ptr(t):
        return 0 if t is None else t.data_ptr()
    dx, ddt, da, db, dc = grads or (None,) * 5
    err = bwd_library().repro_ssd_chunk_bwd(
        _DTYPES[x.dtype], phases, ptr(x), ptr(dt), ptr(a), ptr(bmat),
        ptr(cmat), ptr(dy), ptr(dh_final), ptr(dx), ptr(ddt), ptr(da),
        ptr(db), ptr(dc), *(ptr(scratch[k]) for k in (
            "hprev", "hf", "dstate", "decay", "dcum", "cb")), *dims,
        int(chunk), bwd_groups(bmat, cmat),
        *(st for t in (x, dt, bmat, cmat, dy) for st in t.stride()[:3]),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd kernel launch failed: CUDA error "
                           f"{err}")


def _bwd_prepare(x, dt, a, bmat, cmat, dy, dh_final, chunk):
    if x.device.type != "cuda":
        raise RuntimeError(f"ssd_scan_bwd: no kernel for device {x.device}")
    dt, a, dims = _prepare(x, dt, a, bmat, cmat, chunk)
    b, s, h, p, n = dims
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} does not "
                         f"match x {tuple(x.shape)} on {x.device}")
    dy = dy.to(x.dtype).contiguous()
    if dy.data_ptr() % 16:          # bf16 rows arrive by 16-byte copies
        dy = dy.clone()
    if dh_final is not None:
        if dh_final.shape != (b, h, p, n) or dh_final.device != x.device:
            raise ValueError(f"dh_final {tuple(dh_final.shape)} does not "
                             f"match ({b}, {h}, {p}, {n})")
        dh_final = dh_final.float().contiguous()
    return dt, a, dy, dh_final, dims


def _bwd_grads(x, dims):
    b, s, h, p, n = dims
    return (torch.empty((b, s, h, p), dtype=x.dtype, device=x.device),
            torch.empty((b, s, h), dtype=torch.float32, device=x.device),
            torch.empty((h,), dtype=torch.float32, device=x.device),
            torch.empty((b, s, h, n), dtype=x.dtype, device=x.device),
            torch.empty((b, s, h, n), dtype=x.dtype, device=x.device))


@kernel_site(bwd_work)
def ssd_scan_bwd(x, dt, a, bmat, cmat, dy, dh_final=None, *, chunk=256):
    """The backward kernel: (dx, ddt, da, dB, dC) of ``ssd_scan`` for the
    output gradient ``dy`` (B, S, H, P) and ``dh_final`` (B, H, P, N) of
    h_final (None: zero).  dx, dB and dC in x's dtype, dB and dC per head
    (B, S, H, N); ddt and da in f32.  Recomputes the forward's chunk
    states from the inputs and, in bf16, C B^T once per (batch, chunk,
    group) (``bwd_groups``: one for B and C of head stride 0); its design
    note is at the top of ``csrc/ssd_chunk_bwd.cu``.  A CPU or meta
    tensor takes the plain backward."""
    if x.device.type in PLAIN_DEVICES:
        return ssd_scan_bwd_ref(x, dt, a, bmat, cmat, dy, dh_final,
                                chunk=chunk)
    dt, a, dy, dh_final, dims = _bwd_prepare(x, dt, a, bmat, cmat, dy,
                                             dh_final, chunk)
    scratch = _bwd_scratch(x, bmat, cmat, chunk)
    grads = _bwd_grads(x, dims)
    phases = BWD_STATES | BWD_GRADS
    if x.dtype == torch.bfloat16:
        phases |= BWD_CB
    _launch_bwd(phases, x, dt, a, bmat, cmat, dy, dims, chunk, scratch,
                dh_final=dh_final, grads=grads)
    ssd_scan_bwd.launches.add()     # one per call: every launch of it
    return grads


ssd_scan_bwd.launches = LaunchCounter()


class SSDScanFn(torch.autograd.Function):
    """The SSD scan under autograd on the card: the forward kernel (it
    saves only its inputs: the backward recomputes the chunk states,
    which under remat "full" keeps nothing of the scan between the two
    passes), the backward kernel for its gradient.  Under a cost model on
    the CPU or meta, the plain forward and backward in their place."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, chunk):
        if x.device.type in PLAIN_DEVICES:
            y, hf = ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk)
        else:
            y, hf = _scan(x, dt, a, bmat, cmat, chunk)
        ctx.save_for_backward(x, dt, a, bmat, cmat)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, hf

    @staticmethod
    def backward(ctx, dy, dhf):
        x, dt, a, bmat, cmat = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, da, db, dc = ssd_scan_bwd(x, dt, a, bmat, cmat, dy, dhf,
                                           chunk=ctx.chunk)
        need = ctx.needs_input_grad
        return tuple(g if need[k] else None
                     for k, g in enumerate((dx, ddt, da, db, dc))) + (None,)


# The backward's phases one at a time (CUDA tensors), for holding each to
# its plain version in ``ref.py`` and for planting faults between them;
# these launches are not counted.
def ssd_bwd_states(x, dt, a, bmat, cmat, dy, dh_final=None, *, chunk):
    """Phase 1: the forward's chunk states and state pass, and the reverse
    pass.  Returns the scratch: ``hprev`` (B, H, nc, P, N) the state
    entering each chunk, ``hf`` h_final, ``decay`` (B, H, nc) each chunk's
    cum_last, ``dstate`` (B, H, nc, P, N) the gradient of the state
    leaving each chunk (and ``dcum`` and, in bf16, ``cb``, not yet
    written)."""
    dt, a, dy, dh_final, dims = _bwd_prepare(x, dt, a, bmat, cmat, dy,
                                             dh_final, chunk)
    scratch = _bwd_scratch(x, bmat, cmat, chunk)
    _launch_bwd(BWD_STATES, x, dt, a, bmat, cmat, dy, dims, chunk, scratch,
                dh_final=dh_final)
    return scratch


def _check_scratch(x, bmat, cmat, scratch, chunk):
    for k, shape in _scratch_shapes(x, bmat, cmat, chunk).items():
        t = scratch.get(k)
        if shape is not None and (
                t is None or tuple(t.shape) != shape
                or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"scratch {k} "
                             f"{None if t is None else tuple(t.shape)} does "
                             f"not match {shape}")


def ssd_bwd_cb(x, dt, a, bmat, cmat, dy, scratch, *, chunk):
    """The C B^T phase (bf16): ``scratch["cb"]`` (B, nc, G, T, T) f32
    becomes each chunk's C B^T, once per group (``bwd_groups``), on the
    64 x 64 tile pairs J <= I: the lower triangle, zero above the diagonal
    and past S (the pairs above the diagonal are not written).  Returns
    it."""
    if x.dtype != torch.bfloat16:
        raise TypeError("the C B^T phase is the bf16 backward's")
    dt, a, dy, _, dims = _bwd_prepare(x, dt, a, bmat, cmat, dy, None, chunk)
    _check_scratch(x, bmat, cmat, scratch, chunk)
    _launch_bwd(BWD_CB, x, dt, a, bmat, cmat, dy, dims, chunk, scratch)
    return scratch["cb"]


def ssd_bwd_grads(x, dt, a, bmat, cmat, dy, scratch, *, chunk):
    """Phase 2: (dx, ddt, da, dB, dC) from phase 1's ``scratch`` (its
    tensors contiguous f32, as ``ssd_bwd_states`` returns them; in bf16
    ``cb`` written by ``ssd_bwd_cb``)."""
    dt, a, dy, _, dims = _bwd_prepare(x, dt, a, bmat, cmat, dy, None, chunk)
    _check_scratch(x, bmat, cmat, scratch, chunk)
    grads = _bwd_grads(x, dims)
    _launch_bwd(BWD_GRADS, x, dt, a, bmat, cmat, dy, dims, chunk, scratch,
                grads=grads)
    return grads


def bwd_plan(x, bmat, cmat, *, chunk):
    """The bf16 backward's launches at these inputs' sizes, by name
    (``BWD_LAUNCHES``, launch order): blocks, threads a block, dynamic
    shared memory bytes a block, and blocks an SM holds at once as the
    CUDA runtime's occupancy calculator reports it."""
    b, s, h, p = x.shape
    out = (ctypes.c_longlong * (4 * len(BWD_LAUNCHES)))()
    err = bwd_library().repro_ssd_chunk_bwd_plan(
        b, s, h, p, bmat.shape[3], int(chunk), bwd_groups(bmat, cmat),
        ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd plan failed: CUDA error {err}")
    return {name: dict(zip(("blocks", "threads", "smem", "per_sm"),
                           out[4 * k:4 * k + 4]))
            for k, name in enumerate(BWD_LAUNCHES)}
