"""Wrapper of the SSD chunk-scan kernel (``csrc/ssd_chunk.cu``), in the
(B, S, H, ...) layout of ``repro/kernels/ssd_chunk/ops.py::ssd_scan``.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel on the current stream or raises — there is no
fallback.  The kernel reads x, dt, B and C through their strides (B and C
may be a head-broadcast view of stride 0: read once per group) and writes
y in (B, S, H, P), so the wrapper copies nothing.  In bf16 the scan is
three launches (chunk states, state pass, chunk output) on one f32
scratch; its design note is at the top of its source.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load_library
from ..counter import LaunchCounter, forward_only
from .ref import ssd_scan_ref

SOURCES = ["ssd_chunk.cu"]
MAX_HEAD_DIM = 64
MAX_STATE = 128
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# phases of the bf16 scan (a bit mask of the C entry)
STATES, PASS, OUTPUT = 1, 2, 4


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


def ssd_scan(x, dt, a, bmat, cmat, *, chunk=256):
    """x: (B, S, H, P); dt: (B, S, H) step sizes; a: (H,) negative decay
    rates; b/c: (B, S, H, N).  Returns (y: (B, S, H, P) in x's dtype,
    h_final: (B, H, P, N) f32) — the chunked SSD scan from a zero state."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk)
    if x.device.type != "cuda":
        raise RuntimeError(f"ssd_scan: no kernel for device {x.device}")
    forward_only("ssd_scan", x, dt, a, bmat, cmat)
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
