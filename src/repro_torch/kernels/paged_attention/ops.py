"""Wrappers of the paged decode kernels: GQA (``csrc/paged_decode.cu``)
and absorbed MLA (``csrc/paged_mla_decode.cu``), both split over
positions (``split_plan``) and merged by one combine kernel
(``csrc/paged_combine.cuh``).

Engine-layout arguments, as ``repro/kernels/paged_attention/ops.py``
takes them: one decode token per slot, pools as the paged KV cache
stores them.  A CPU or meta tensor goes to the plain version (``ref.py``); a
CUDA tensor launches the kernel on the current stream or raises — there
is no fallback.  Under a cost model (``counter.kernel_site``) a call is
charged its kernel's own work (``work``, ``mla_work``).  Each kernel's
design note is at the top of its source.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load_library
from ..counter import (PLAIN_DEVICES, LaunchCounter, forward_only,
                       kernel_site)
from .ref import paged_decode_attention_ref, paged_mla_decode_attention_ref

SOURCES = ["paged_decode.cu"]
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16
# positions per split block of the GQA decode (rounded up to whole pages),
# and the grid's z limit, which caps the number of splits
SPLIT_POSITIONS = 256
MAX_GRID_Z = 65535
MLA_SOURCES = ["paged_mla_decode.cu"]
MLA_LATENT_DIMS = (16, 32, 64, 128, 256)
MLA_MAX_ROPE_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def library() -> ctypes.CDLL:
    """The built kernel library (``nvcc`` at first use)."""
    lib = load_library("paged_decode", SOURCES)
    fn = lib.repro_paged_decode
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       f, i, i, p]
        fn.restype = i
        lib.repro_paged_decode_split.argtypes = [i, p, p, p, p, p, p, p, p,
                                                 i, i, i, i, i, i, i, i, f,
                                                 i, i, p]
        lib.repro_paged_decode_split.restype = i
        lib.repro_paged_decode_combine.argtypes = [i, p, p, p, p, i, i, i, p]
        lib.repro_paged_decode_combine.restype = i
    return lib


def split_plan(capacity, page_size):
    """(n_split, split_len) of the paged decodes (GQA and MLA): blocks of
    ``split_len`` consecutive positions (whole pages, about
    ``SPLIT_POSITIONS``) cover
    the table's ``capacity`` positions in at most ``MAX_GRID_Z`` splits.
    A pure function of shapes: it never reads the slots' positions, which
    live on the card."""
    ps = page_size
    length = ps * -(-SPLIT_POSITIONS // ps)
    n = -(-capacity // length)
    if n > MAX_GRID_Z:              # fewer, longer splits
        per_split = -(-capacity // MAX_GRID_Z)
        length = ps * -(-per_split // ps)
        n = -(-capacity // length)
    return n, length


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
        if name not in ("k_pool", "v_pool") and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _pool_heads(k_pool, v_pool)
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _pool_heads(k_pool, v_pool) -> int:
    """The heads per position row of the pools ``k_pool`` / ``v_pool``
    are views of: a pool itself, or a view of some of its heads (a
    narrow of dim 2, as a tensor-parallel rank whose query heads read one
    KV head of a pool whole on every rank passes it).  Anything else
    raises."""
    _, ps, hkv, dh = k_pool.shape
    st = k_pool.stride()
    if v_pool.stride() != st or st[3] != 1 or st[2] != dh \
            or st[1] % dh or st[1] < hkv * dh or st[0] != ps * st[1]:
        raise ValueError(f"k/v pools with strides {st} / {v_pool.stride()}:"
                         " need a pool (P, page_size, Hs, Dh), contiguous, "
                         "or a view of some of its heads")
    return st[1] // dh


def _live(table, pos, page_size, window=None) -> int:
    """The cached positions the slots' decodes read: pos + 1 a slot, at
    most ``window``.  On meta pos holds no value: every slot counts its
    table's capacity (a dry run's decode cell is full to its last
    position)."""
    cap = table.shape[1] * page_size
    if pos.device.type == "meta":
        per = torch.full(pos.shape, cap)
    else:
        per = pos.long().cpu() + 1
    if window:
        per = per.clamp(max=window)
    return int(per.sum())


def work(q, k_pool, v_pool, table, pos, *, page_size, window=None,
         scale=None):
    """(FLOPs, bytes) of one call: two products over the live positions
    (``_live``); their K and V rows read once, q read and the output
    written once, the table and pos read."""
    h, dh = q.shape[2], q.shape[3]
    live = _live(table, pos, page_size, window)
    return 4 * live * h * dh, (
        2 * live * k_pool.shape[2] * dh * k_pool.element_size()
        + 2 * q.numel() * q.element_size() + table.numel() * 4
        + pos.numel() * 4)


@kernel_site(work)
def paged_decode_attention(q, k_pool, v_pool, table, pos, *, page_size,
                           window=None, scale=None):
    """q: (B, 1, H, Dh) — one decode token per slot; k/v pools:
    (P, page_size, Hkv, Dh), or views of Hkv of a pool's heads
    (``_pool_heads``), read in place; table: (B, pages_per_slot) int32 block
    table (page 0 = garbage page); pos: (B,) int32 per-slot positions.
    Returns (B, 1, H, Dh) in q's dtype."""
    if q.device.type in PLAIN_DEVICES:
        return paged_decode_attention_ref(q, k_pool, v_pool, table, pos,
                                          page_size=page_size,
                                          window=window, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_decode_attention: no kernel for "
                           f"device {q.device}")
    forward_only("paged_decode_attention", q, k_pool, v_pool)
    _check(q, k_pool, v_pool, table, pos, page_size)
    b, _, h, dh = q.shape
    hkv, pps = k_pool.shape[2], table.shape[1]
    scale = (dh ** -0.5) if scale is None else float(scale)
    n_split, split_len = split_plan(pps * page_size, page_size)
    out = torch.empty_like(q)
    parts = (None, None, None)
    if n_split > 1:     # one scratch allocation: the tick is host-bound
        scratch = _scratch(q, n_split)
        parts = _part_ptrs(scratch.data_ptr(), n_split * b * h, dh)
    err = library().repro_paged_decode(
        _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), pos.data_ptr(), out.data_ptr(), *parts, b, h, hkv,
        _pool_heads(k_pool, v_pool), dh, pps, page_size,
        0 if window is None else int(window), scale, n_split, split_len,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_decode_attention.launches.add()   # one per call: split + combine
    return out


paged_decode_attention.launches = LaunchCounter()


def _scratch(q, n_split):
    """f32 scratch of the split partials: acc (n_split, B, H, Dh), then m
    and l (n_split, B, H)."""
    b, _, h, dh = q.shape
    return torch.empty(n_split * b * h * (dh + 2), dtype=torch.float32,
                       device=q.device)


def _part_views(scratch, n_split, b, h, dh):
    """The partials in a scratch: acc (n_split, B, H, Dh), m and l
    (n_split, B, H)."""
    rows = n_split * b * h
    return (scratch[:rows * dh].view(n_split, b, h, dh),
            scratch[rows * dh:rows * (dh + 1)].view(n_split, b, h),
            scratch[rows * (dh + 1):].view(n_split, b, h))


def _part_ptrs(base, rows, dh):
    """Addresses of acc, m and l in a scratch of ``rows`` partial rows."""
    return base, base + 4 * rows * dh, base + 4 * rows * (dh + 1)


def paged_decode_partials(q, k_pool, v_pool, table, pos, *, page_size,
                          n_split, split_len, window=None, scale=None):
    """The split kernel alone (CUDA tensors): the partials (acc (n_split, B,
    H, Dh), m and l (n_split, B, H), f32, m in log2 units) that the combine
    merges.  For holding the combine kernel against its plain version on
    the kernel's own partials; not counted as a launch of the wrapper."""
    _check(q, k_pool, v_pool, table, pos, page_size)
    b, _, h, dh = q.shape
    hkv, pps = k_pool.shape[2], table.shape[1]
    scale = (dh ** -0.5) if scale is None else float(scale)
    rows = n_split * b * h
    scratch = _scratch(q, n_split)
    err = library().repro_paged_decode_split(
        _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), pos.data_ptr(), *_part_ptrs(scratch.data_ptr(),
                                                      rows, dh),
        b, h, hkv, _pool_heads(k_pool, v_pool), dh, pps, page_size,
        0 if window is None else int(window), scale, n_split, split_len,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode split launch failed: CUDA error "
                           f"{err}")
    return _part_views(scratch, n_split, b, h, dh)


def paged_decode_combine(acc, m, l, dtype):
    """The combine kernel alone (CUDA tensors): partials -> (B, 1, H, Dh)
    in ``dtype``; the counterpart of ``ref.paged_decode_combine_ref``."""
    n_split, b, h, dh = acc.shape
    if not all(t.is_cuda and t.is_contiguous() and t.dtype == torch.float32
               for t in (acc, m, l)) or m.shape != (n_split, b, h) \
            or l.shape != m.shape:
        raise ValueError("partials must be contiguous f32 CUDA tensors of "
                         "shapes (S, B, H, Dh), (S, B, H), (S, B, H)")
    out = torch.empty((b, 1, h, dh), dtype=dtype, device=acc.device)
    err = library().repro_paged_decode_combine(
        _DTYPES[dtype], acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        out.data_ptr(), n_split, b * h, dh,
        torch.cuda.current_stream(acc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode combine launch failed: CUDA error "
                           f"{err}")
    return out


# ------------------------------------------------------------- absorbed MLA
def mla_library() -> ctypes.CDLL:
    """The built MLA kernel library (``nvcc`` at first use)."""
    lib = load_library("paged_mla_decode", MLA_SOURCES)
    fn = lib.repro_paged_mla_decode
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i] + [p] * 10 + [i] * 6 + [f, i, i, p]
        fn.restype = i
        lib.repro_paged_mla_decode_split.argtypes = ([p] * 9 + [i] * 6
                                                     + [f, i, i, p])
        lib.repro_paged_mla_decode_split.restype = i
    return lib


def _check_mla(q_lat, q_rope, ckv_pool, krope_pool, table, pos, page_size):
    if q_lat.dim() != 4 or q_lat.shape[1] != 1:
        raise ValueError(f"q_lat must be (B, 1, H, Rkv), got "
                         f"{tuple(q_lat.shape)}")
    b, _, h, rkv = q_lat.shape
    if q_rope.dim() != 4 or q_rope.shape[:3] != q_lat.shape[:3]:
        raise ValueError(f"q_rope {tuple(q_rope.shape)} does not match "
                         f"q_lat {tuple(q_lat.shape)}")
    dr = q_rope.shape[3]
    if ckv_pool.dim() != 3 or krope_pool.dim() != 3 \
            or ckv_pool.shape[:2] != krope_pool.shape[:2] \
            or ckv_pool.shape[1] != page_size or ckv_pool.shape[2] != rkv \
            or krope_pool.shape[2] != dr:
        raise ValueError(f"pools {tuple(ckv_pool.shape)} / "
                         f"{tuple(krope_pool.shape)} do not match page_size "
                         f"{page_size}, Rkv {rkv}, Dr {dr}")
    if rkv not in MLA_LATENT_DIMS:
        raise ValueError(f"latent dim {rkv} not in {MLA_LATENT_DIMS}")
    if dr % 8 or not 0 < dr <= MLA_MAX_ROPE_DIM:
        raise ValueError(f"rope dim {dr}: need a multiple of 8 in "
                         f"[8, {MLA_MAX_ROPE_DIM}]")
    ts = (q_lat, q_rope, ckv_pool, krope_pool)
    if q_lat.dtype not in _DTYPES or any(t.dtype != q_lat.dtype for t in ts):
        raise TypeError(f"dtypes {[str(t.dtype) for t in ts]}: need "
                        "matching float32 or bfloat16")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("table and pos must be int32")
    if table.dim() != 2 or table.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"table {tuple(table.shape)} / pos "
                         f"{tuple(pos.shape)} do not match {b} slots")
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope),
                    ("ckv_pool", ckv_pool), ("krope_pool", krope_pool),
                    ("table", table), ("pos", pos)):
        if t.device != q_lat.device:
            raise ValueError(f"{name} is on {t.device}, q_lat on "
                             f"{q_lat.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def mla_work(q_lat, q_rope, ckv_pool, krope_pool, table, pos, *,
             page_size, scale):
    """(FLOPs, bytes) of one call: per live position (``_live``) and head
    the score over latent and rope and the latent sum; each position's
    latent and rope rows read once, q read and the output written once,
    the table and pos read."""
    h, rkv, dr = q_lat.shape[2], q_lat.shape[3], q_rope.shape[3]
    live = _live(table, pos, page_size)
    e = q_lat.element_size()
    return 2 * live * h * (2 * rkv + dr), (
        live * (rkv + dr) * e + (2 * q_lat.numel() + q_rope.numel()) * e
        + table.numel() * 4 + pos.numel() * 4)


@kernel_site(mla_work)
def paged_mla_decode_attention(q_lat, q_rope, ckv_pool, krope_pool, table,
                               pos, *, page_size, scale):
    """Absorbed MLA decode over paged latent pools.  q_lat: (B, 1, H, Rkv)
    (q_nope already absorbed through wk_b); q_rope: (B, 1, H, Dr); pools:
    (P, page_size, Rkv) / (P, page_size, Dr); table: (B, pages_per_slot)
    int32 (page 0 = garbage page); pos: (B,) int32.  Returns the attended
    latent (B, 1, H, Rkv) in q_lat's dtype; the caller applies wv_b."""
    if q_lat.device.type in PLAIN_DEVICES:
        return paged_mla_decode_attention_ref(
            q_lat, q_rope, ckv_pool, krope_pool, table, pos,
            page_size=page_size, scale=scale)
    if q_lat.device.type != "cuda":
        raise RuntimeError(f"paged_mla_decode_attention: no kernel for "
                           f"device {q_lat.device}")
    forward_only("paged_mla_decode_attention", q_lat, q_rope, ckv_pool,
                 krope_pool)
    _check_mla(q_lat, q_rope, ckv_pool, krope_pool, table, pos, page_size)
    b, _, h, rkv = q_lat.shape
    n_split, split_len = split_plan(table.shape[1] * page_size, page_size)
    out = torch.empty_like(q_lat)
    parts = (None, None, None)      # f32 runs unsplit; one split: direct
    if q_lat.dtype == torch.bfloat16 and n_split > 1:
        scratch = _scratch(q_lat, n_split)
        parts = _part_ptrs(scratch.data_ptr(), n_split * b * h, rkv)
    err = mla_library().repro_paged_mla_decode(
        _DTYPES[q_lat.dtype], q_lat.data_ptr(), q_rope.data_ptr(),
        ckv_pool.data_ptr(), krope_pool.data_ptr(), table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), *parts, b, h, rkv, q_rope.shape[3],
        table.shape[1], page_size, float(scale), n_split, split_len,
        torch.cuda.current_stream(q_lat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_mla_decode kernel launch failed: CUDA "
                           f"error {err}")
    paged_mla_decode_attention.launches.add()  # one a call: split, combine
    return out


paged_mla_decode_attention.launches = LaunchCounter()


def paged_mla_decode_partials(q_lat, q_rope, ckv_pool, krope_pool, table,
                              pos, *, page_size, scale, n_split, split_len):
    """The bf16 MLA split kernel alone (CUDA tensors): the partials (acc
    (n_split, B, H, Rkv), m and l (n_split, B, H), f32, m in log2 units)
    that ``paged_decode_combine`` merges — the counterpart of
    ``ref.paged_mla_decode_partials_ref``; not counted as a launch."""
    _check_mla(q_lat, q_rope, ckv_pool, krope_pool, table, pos, page_size)
    if q_lat.dtype != torch.bfloat16:
        raise TypeError("the MLA split kernel is the bf16 path")
    b, _, h, rkv = q_lat.shape
    rows = n_split * b * h
    scratch = _scratch(q_lat, n_split)
    err = mla_library().repro_paged_mla_decode_split(
        q_lat.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(),
        krope_pool.data_ptr(), table.data_ptr(), pos.data_ptr(),
        *_part_ptrs(scratch.data_ptr(), rows, rkv), b, h, rkv,
        q_rope.shape[3], table.shape[1], page_size, float(scale), n_split,
        split_len, torch.cuda.current_stream(q_lat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_mla_decode split launch failed: CUDA "
                           f"error {err}")
    return _part_views(scratch, n_split, b, h, rkv)
