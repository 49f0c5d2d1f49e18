"""Wrapper of the paged GQA decode kernel (``csrc/paged_decode.cu``).

Engine-layout arguments, as ``repro/kernels/paged_attention/ops.py``
takes them: one decode token per slot, pools as the paged KV cache
stores them.  A CPU tensor goes to the plain version (``ref.py``); a
CUDA tensor launches the kernel on the current stream or raises — there
is no fallback.  The kernel's design note is at the top of its source.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load_library
from ..counter import LaunchCounter
from .ref import paged_decode_attention_ref

SOURCES = ["paged_decode.cu"]
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def library() -> ctypes.CDLL:
    """The built kernel library (``nvcc`` at first use)."""
    lib = load_library("paged_decode", SOURCES)
    fn = lib.repro_paged_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = i
    return lib


def _check(q, k_pool, v_pool, table, pos, page_size):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, Dh), got {tuple(q.shape)}")
    b, _, h, dh = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("k/v pools must be equal (P, page_size, Hkv, Dh), "
                         f"got {tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    _, ps, hkv, dh_kv = k_pool.shape
    if ps != page_size or dh_kv != dh:
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match "
                         f"page_size {page_size} / head_dim {dh}")
    if h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"heads {h} / kv heads {hkv}: group must divide "
                         f"and be <= {MAX_GROUP}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k_pool.dtype}/{v_pool.dtype}: "
                        "need matching float32 or bfloat16")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("table and pos must be int32")
    if table.dim() != 2 or table.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"table {tuple(table.shape)} / pos "
                         f"{tuple(pos.shape)} do not match {b} slots")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("table", table), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_decode_attention(q, k_pool, v_pool, table, pos, *, page_size,
                           window=None, scale=None):
    """q: (B, 1, H, Dh) — one decode token per slot; k/v pools:
    (P, page_size, Hkv, Dh); table: (B, pages_per_slot) int32 block
    table (page 0 = garbage page); pos: (B,) int32 per-slot positions.
    Returns (B, 1, H, Dh) in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, table, pos,
                                          page_size=page_size,
                                          window=window, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_decode_attention: no kernel for "
                           f"device {q.device}")
    _check(q, k_pool, v_pool, table, pos, page_size)
    b, _, h, dh = q.shape
    hkv = k_pool.shape[2]
    scale = (dh ** -0.5) if scale is None else float(scale)
    out = torch.empty_like(q)
    fn = library().repro_paged_decode
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
             v_pool.data_ptr(), table.data_ptr(), pos.data_ptr(),
             out.data_ptr(), b, h, hkv, dh, table.shape[1], page_size,
             0 if window is None else int(window), scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_decode_attention.launches.add()
    return out


paged_decode_attention.launches = LaunchCounter()
