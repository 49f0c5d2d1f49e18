"""Plain PyTorch versions of the paged decode kernels (GQA and absorbed
MLA): gather the pages dense (the copy the kernels avoid) and attend with
a masked f32 softmax — the semantics of
``repro/kernels/paged_attention/ref.py``.  The CPU paths of the wrappers
in :mod:`.ops` and the kernels' oracles on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634


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


def paged_decode_partials_ref(q, k_pool, v_pool, table, pos, *, page_size,
                              edges, window=None, scale=None):
    """The split kernel's function in plain PyTorch: split z scores the
    valid positions t with ``edges[z] <= t < edges[z + 1]`` and gives its
    unnormalised f32 accumulator acc (S, B, H, Dh), its max m and sum l
    (S, B, H), in log2 units (scores times log2(e), so that p = 2^(s -
    m)).  A split with no valid position gives m = -inf, l = 0, acc = 0."""
    b, _, h, dh = q.shape
    hkv = k_pool.shape[2]
    kd = _gather(k_pool, table, page_size).float()
    vd = _gather(v_pool, table, page_size).float()
    kd = kd.repeat_interleave(h // hkv, dim=2)
    vd = vd.repeat_interleave(h // hkv, dim=2)
    scale = (dh ** -0.5) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhk", q.float(), kd) * (scale * LOG2E)
    kj = torch.arange(kd.shape[1], device=q.device)[None, :]
    p_ = pos.long()[:, None]
    ok = kj <= p_
    if window is not None:
        ok &= kj > p_ - window
    return _partials(s, vd, ok, edges)


def _partials(s, v, ok, edges):
    """Per split [lo, hi) of ``edges``: the unnormalised accumulator of
    the log2-unit scores s (B, H, T) over the values v (B, T, H, D) at the
    valid positions ``ok`` (B, T), its max m and sum l.  A split with no
    valid position gives m = -inf, l = 0, acc = 0."""
    kj = torch.arange(s.shape[-1], device=s.device)[None, :]
    accs, ms, ls = [], [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        live = (ok & (kj >= lo) & (kj < hi))[:, None, :]        # (B, 1, T)
        m = torch.where(live, s, -torch.inf).amax(-1)           # (B, H)
        p = torch.where(live, torch.exp2(s - torch.where(
            torch.isfinite(m), m, 0.0)[..., None]), 0.0)
        accs.append(torch.einsum("bhk,bkhd->bhd", p, v))
        ms.append(m)
        ls.append(p.sum(-1))
    return torch.stack(accs), torch.stack(ms), torch.stack(ls)


def paged_decode_combine_ref(acc, m, l, dtype):
    """Merge the partials (acc (S, B, H, Dh), m and l (S, B, H), log2
    units) of each row by log-sum-exp over its splits with l > 0 (an empty
    split's acc is never read); a row with none gives zeros.  Returns (B, 1, H, Dh) in ``dtype``."""
    live = l > 0
    mx = torch.where(live, m, -torch.inf).amax(0)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    f = torch.where(live, torch.exp2(m - mx), 0.0)
    den = (l * f).sum(0)
    num = torch.where(live[..., None], acc * f[..., None], 0.0).sum(0)
    out = torch.where(den[..., None] > 0,
                      num / torch.where(den > 0, den, 1.0)[..., None], 0.0)
    return out[:, None].to(dtype)


def paged_mla_decode_attention_ref(q_lat, q_rope, ckv_pool, krope_pool,
                                   table, pos, *, page_size, scale):
    """Same signature/layout as ``ops.paged_mla_decode_attention``: gather
    the latent pages dense, score ``q_lat . ckv + q_rope . krope`` in f32,
    masked softmax, attend over the latent itself (the absorbed form's V
    is its K).  A row with no valid position gives zeros."""
    cd = _gather(ckv_pool, table, page_size)    # (B, T, Rkv)
    kd = _gather(krope_pool, table, page_size)  # (B, T, Dr)
    scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), cd.float())
              + torch.einsum("bshr,btr->bhst", q_rope.float(),
                             kd.float())) * scale
    ok = (torch.arange(cd.shape[1], device=q_lat.device)[None, :]
          <= pos.long()[:, None])
    scores = torch.where(ok[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    lat = torch.einsum("bhst,btr->bshr", probs, cd.float())
    any_valid = ok.any(dim=1)[:, None, None, None]
    return torch.where(any_valid, lat, 0.0).to(q_lat.dtype)


def paged_mla_decode_partials_ref(q_lat, q_rope, ckv_pool, krope_pool,
                                  table, pos, *, page_size, scale, edges):
    """The MLA split kernel's function in plain PyTorch: split z scores the
    valid positions t with ``edges[z] <= t < edges[z + 1]`` and gives its
    unnormalised f32 accumulator over the latent rows acc (S, B, H, Rkv),
    its max m and sum l (S, B, H), in log2 units; an empty split gives m =
    -inf, l = 0.  ``paged_decode_combine_ref`` merges them."""
    cd = _gather(ckv_pool, table, page_size).float()        # (B, T, Rkv)
    kd = _gather(krope_pool, table, page_size).float()      # (B, T, Dr)
    s = (torch.einsum("bqhr,btr->bht", q_lat.float(), cd)
         + torch.einsum("bqhr,btr->bht", q_rope.float(), kd)) \
        * (scale * LOG2E)
    ok = (torch.arange(cd.shape[1], device=cd.device)[None, :]
          <= pos.long()[:, None])
    b, t, rkv = cd.shape
    return _partials(s, cd[:, :, None].expand(b, t, q_lat.shape[2], rkv),
                     ok, edges)
