"""Wrapper of the SSD chunk-scan kernel (``csrc/ssd_chunk.cu``), in the
(B, S, H, ...) layout of ``repro/kernels/ssd_chunk/ops.py::ssd_scan``.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel on the current stream or raises — there is no
fallback.  The wrapper hands the kernel the reference kernel's
(B*H, S, ...) layout, contiguous (B and C broadcast to every head); the
kernel's design note is at the top of its source.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load_library
from ..counter import LaunchCounter
from .ref import ssd_scan_ref

SOURCES = ["ssd_chunk.cu"]
MAX_HEAD_DIM = 64
MAX_STATE = 128
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def library() -> ctypes.CDLL:
    """The built kernel library (``nvcc`` at first use)."""
    lib = load_library("ssd_chunk", SOURCES)
    fn = lib.repro_ssd_chunk_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, p]
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


def _flat(t):
    """(B, S, H, ...) -> contiguous (B*H, S, ...)."""
    b, s, h = t.shape[:3]
    return t.transpose(1, 2).reshape((b * h, s) + tuple(t.shape[3:])) \
        .contiguous()


def ssd_scan(x, dt, a, bmat, cmat, *, chunk=256):
    """x: (B, S, H, P); dt: (B, S, H) step sizes; a: (H,) negative decay
    rates; b/c: (B, S, H, N).  Returns (y: (B, S, H, P) in x's dtype,
    h_final: (B, H, P, N) f32) — the chunked SSD scan from a zero state."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk)
    if x.device.type != "cuda":
        raise RuntimeError(f"ssd_scan: no kernel for device {x.device}")
    _check(x, dt, a, bmat, cmat, chunk)
    b, s, h, p = x.shape
    n = bmat.shape[3]
    xf, bf, cf = _flat(x), _flat(bmat), _flat(cmat)
    dtf = _flat(dt.float())
    af = a.float().expand(b, h).contiguous()
    y = torch.empty((b * h, s, p), dtype=x.dtype, device=x.device)
    hf = torch.empty((b * h, p, n), dtype=torch.float32, device=x.device)
    fn = library().repro_ssd_chunk_scan
    err = fn(_DTYPES[x.dtype], xf.data_ptr(), dtf.data_ptr(), af.data_ptr(),
             bf.data_ptr(), cf.data_ptr(), y.data_ptr(), hf.data_ptr(),
             b * h, s, p, n, int(chunk),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error "
                           f"{err}")
    ssd_scan.launches.add()
    return (y.view(b, h, s, p).transpose(1, 2),
            hf.view(b, h, p, n))


ssd_scan.launches = LaunchCounter()
