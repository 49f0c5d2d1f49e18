"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``), in
the (B, S, H, D) layout of ``repro/kernels/flash_attention/ops.py``.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel on the current stream or raises — there is no
fallback.  bf16 runs on the tensor cores, f32 on the CUDA cores.  The
reference's ``block_q``, ``block_k`` and ``interpret`` are TPU tiling
knobs: the kernel picks its own tiles.  Its design note is at the top of
its source.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load_library
from ..counter import LaunchCounter
from .ref import flash_attention_ref

SOURCES = ["flash_attention.cu"]
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def library() -> ctypes.CDLL:
    """The built kernel library (``nvcc`` at first use)."""
    lib = load_library("flash_attention", SOURCES)
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = i
    return lib


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Sq, H, D) and equal k/v (B, Sk, Hkv, "
                         f"D), got {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    hkv = k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"heads {h} / kv heads {hkv}: the group must divide")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window {window}: need >= 1 or None")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                        "matching float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, H, D) in q's
    dtype.  Causal masking is top-left aligned (key j <= query i); the
    window keeps keys j > i - window; flat head h reads kv head
    h // (H / Hkv); a row with no valid key gives zeros."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device "
                           f"{q.device}")
    _check(q, k, v, window)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    scale = (d ** -0.5) if scale is None else float(scale)
    fn = library().repro_flash_attention
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), b, sq, sk, h, hkv, d, int(bool(causal)),
             0 if window is None else int(window), scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches.add()
    return out


flash_attention.launches = LaunchCounter()
