"""Plain PyTorch version of the paged decode kernel: gather the pages
dense (the copy the kernel avoids) and attend with a masked f32 softmax —
the semantics of ``repro/kernels/paged_attention/ref.py``.  The CPU path
of :func:`..ops.paged_decode_attention` and the kernel's oracle on the
card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gather(pool, table, page_size):
    b, pps = table.shape
    return pool[table.long()].reshape((b, pps * page_size) + pool.shape[2:])


def paged_decode_attention_ref(q, k_pool, v_pool, table, pos, *,
                               page_size, window=None, scale=None):
    """Same signature/layout as ``ops.paged_decode_attention``."""
    b, _, h, dh = q.shape
    hkv = k_pool.shape[2]
    kd = _gather(k_pool, table, page_size)      # (B, T, Hkv, Dh)
    vd = _gather(v_pool, table, page_size)
    rep = h // hkv
    # flat head h reads kv head h // rep (kv-head-major group order)
    kd = kd.repeat_interleave(rep, dim=2)
    vd = vd.repeat_interleave(rep, dim=2)
    scale = (dh ** -0.5) if scale is None else scale
    kj = torch.arange(kd.shape[1], device=q.device)[None, :]
    p = pos.long()[:, None]
    ok = kj <= p
    if window is not None:
        ok &= kj > p - window
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kd.float()) * scale
    scores = torch.where(ok[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vd.float())
    any_valid = ok.any(dim=1)[:, None, None, None]
    return torch.where(any_valid, out, 0.0).to(q.dtype)
