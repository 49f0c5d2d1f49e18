"""GQA attention (PyTorch port of the GQA half of
``repro/models/attention.py``).

Three paths, as in the reference: ``full`` (materialised scores, train),
``qchunk`` (a loop over query chunks, prefill) and ``decode`` (one query
token per slot against a dense or paged cache).  On the paged decode leg
with ``pages["kernel"]`` set, attention runs in the hand-written CUDA
kernel (``repro_torch.kernels.paged_decode_attention``), which reads the
pages in place through the block table.

Caches are updated in place: a decode step writes the new token's K/V
into the pool it was given and returns the same tensors (the shape/dtype
contract of ``layers.check_cache_invariant``).  The cast points of the
reference are kept, because bf16 equality depends on them: probabilities
are cast to q's dtype before the PV product, decode divides by the
softmax sum after the bf16 PV product, and weights are cast to the
activation dtype at each use.  MLA and the verify / prefill_chunk modes
belong to later slices and raise.
"""
from __future__ import annotations

import torch

from ..kernels import paged_decode_attention
from .layers import apply_rope, page_gather, page_scatter, rms_norm

NEG_INF = -1e30


def paged_leaf(pages, window, cache_len=None):
    """Is this attention cache leaf a paged pool?  Only linear caches are
    paged: ``window is None`` or a ring that degenerates to linear
    (``window >= cache_len``)."""
    if pages is None:
        return False
    cl = pages["cache_len"] if cache_len is None else cache_len
    return window is None or window >= cl


def _expand_kv(k, n_heads):
    """(B, S, Hkv, Dh) -> (B, S, H, Dh) by group broadcast: flat head h
    reads kv head h // (H / Hkv)."""
    b, s, hkv, dh = k.shape
    if hkv == n_heads:
        return k
    rep = n_heads // hkv
    return k[:, :, :, None, :].expand(b, s, hkv, rep, dh).reshape(
        b, s, n_heads, dh)


def _mask_bias(sq, sk, q_off, window, device):
    """(sq, sk) additive causal(+window) mask; q position = q_off + i."""
    qi = q_off + torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    ok = kj <= qi
    if window is not None:
        ok &= kj > qi - window
    return torch.where(ok, 0.0, NEG_INF).float()


def _sdpa(q, k, v, bias, scale=None):
    """q: (B,Sq,H,Dh) k/v: (B,Sk,H,Dh) bias: (Sq,Sk). f32 softmax."""
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * scale + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def full_attention(q, k, v, *, window=None, q_off=0, scale=None):
    k = _expand_kv(k, q.shape[2])
    v = _expand_kv(v, q.shape[2])
    bias = _mask_bias(q.shape[1], k.shape[1], q_off, window, q.device)
    return _sdpa(q, k, v, bias, scale)


def qchunk_attention(q, k, v, *, window=None, chunk=512, scale=None):
    """Forward-only prefill: loop over query chunks vs full K/V."""
    b, s, h, dh = q.shape
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    n = max(1, s // chunk)
    chunk = s // n
    if n * chunk != s:
        raise ValueError(f"qchunk_attention: {s} positions do not split "
                         f"into {n} equal chunks")
    outs = []
    for i in range(n):
        bias = _mask_bias(chunk, s, i * chunk, window, q.device)
        outs.append(_sdpa(q[:, i * chunk:(i + 1) * chunk], k, v, bias,
                          scale))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, pos, *, window=None, scale=None):
    """q: (B,1,H,Dh); caches: (B,Sc,Hkv,Dh); pos: scalar or (B,) per-slot
    positions.  Partial-softmax formulation of the reference: the PV
    product runs on unnormalised probabilities in q's dtype and the sum
    divides at the end."""
    b, _, h, dh = q.shape
    sc = k_cache.shape[1]
    kf = _expand_kv(k_cache, h)
    vf = _expand_kv(v_cache, h)
    slots = torch.arange(sc, device=q.device)
    pos = torch.as_tensor(pos, device=q.device)
    per_slot = pos.dim() == 1
    pp = pos[:, None] if per_slot else pos          # (B,1) | scalar
    if window is None:
        valid = slots <= pp
    else:
        slot_pos = pp - torch.remainder(pp - slots, sc)   # ring: sc == window
        valid = slot_pos >= 0
    bias = torch.where(valid, 0.0, NEG_INF).float()
    bias = bias[:, None, None, :] if per_slot else bias[None, None, None, :]
    scale = (dh ** -0.5) if scale is None else scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kf).float()
    scores = scores * scale + bias
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), vf)
    return out / l.transpose(1, 2).to(q.dtype)      # (B,1,H,1)


# ====================================================================== GQA
def gqa_param_shapes(cfg):
    """Flat (d, H*dh) weights, as the reference stores them:
    name -> (shape, init kind)."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {
        "ln": ((d,), "ones"),
        "wq": ((d, h * dh), "normal"),
        "wk": ((d, hkv * dh), "normal"),
        "wv": ((d, hkv * dh), "normal"),
        "wo": ((h * dh, d), "normal"),
    }
    if cfg.qkv_bias:
        shapes["bq"] = ((h * dh,), "zeros")
        shapes["bk"] = ((hkv * dh,), "zeros")
        shapes["bv"] = ((hkv * dh,), "zeros")
    return shapes


def gqa_cache_shapes(cfg, spec, batch, seq):
    sc = min(seq, spec.window) if spec.window else seq
    kv = (batch, sc, cfg.n_kv_heads, cfg.head_dim)
    return {"k": kv, "v": kv}


def _cache_update(c, u, idx):
    """Write the decode-step update ``u`` (B,1,...) into cache ``c``
    (B,Sc,...) at sequence index ``idx`` — a scalar or (B,) per-slot
    positions — in place; ``c`` keeps its shape and dtype."""
    if u.shape[0] != c.shape[0] or u.shape[2:] != c.shape[2:]:
        raise ValueError(f"cache update {tuple(u.shape)} into "
                         f"{tuple(c.shape)}")
    idx = torch.as_tensor(idx, device=c.device).long()
    if idx.dim() == 0:
        c.index_copy_(1, idx.view(1), u.to(c.dtype))
    else:
        c[torch.arange(c.shape[0], device=c.device), idx] = \
            u[:, 0].to(c.dtype)
    return c


def _pad_seq(t, target):
    """Right-pad dim 1 (sequence) with zeros up to ``target`` slots."""
    if target is None or t.shape[1] >= target:
        return t
    out = t.new_zeros((t.shape[0], target) + tuple(t.shape[2:]))
    out[:, :t.shape[1]] = t
    return out


def gqa_apply(x, p, cfg, spec, *, mode, pos, cache=None, cache_len=None,
              pages=None):
    """x: (B,S,D) -> (out, new_cache or None).  cache: {"k","v"}
    unexpanded.  With ``pages`` (decode) the K/V leaves are paged pools
    (P, page_size, Hkv, Dh): the new token's K/V is scattered through the
    block table, then attention reads a gathered dense view — or, with
    ``pages["kernel"]``, the pages in place in the CUDA kernel."""
    if mode in ("verify", "prefill_chunk"):
        raise NotImplementedError(
            f"gqa_apply mode {mode!r} is not ported yet (ROADMAP.md queue 1, "
            "item 5: serve features past the main path)")
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    xn = rms_norm(x, p["ln"], cfg.norm_eps)

    q = (xn @ p["wq"].to(dt)).view(b, s, h, dh)
    k = (xn @ p["wk"].to(dt)).view(b, s, hkv, dh)
    v = (xn @ p["wv"].to(dt)).view(b, s, hkv, dh)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt).view(h, dh)
        k = k + p["bk"].to(dt).view(hkv, dh)
        v = v + p["bv"].to(dt).view(hkv, dh)

    if mode == "decode":
        pos = torch.as_tensor(pos, device=x.device)
        rp = pos[:, None] if pos.dim() == 1 else pos       # (B,1) | scalar
        if cfg.pos_emb == "rope":
            q = apply_rope(q, rp, cfg.rope_theta)
            k = apply_rope(k, rp, cfg.rope_theta)
        kc, vc = cache["k"], cache["v"]
        w = spec.window
        if paged_leaf(pages, w):
            table, ps = pages["table"], pages["page_size"]
            page_scatter(kc, table, ps, pos, k)
            page_scatter(vc, table, ps, pos, v)
            if pages.get("kernel"):
                pv = pos if pos.dim() == 1 else pos.expand(b)
                out = paged_decode_attention(
                    q.contiguous(), kc, vc, table.int(), pv.int(),
                    page_size=ps, window=w)
            else:
                out = decode_attention(q, page_gather(kc, table, ps),
                                       page_gather(vc, table, ps), pos,
                                       window=w)
        else:
            idx = torch.remainder(pos, kc.shape[1]) if w is not None else pos
            _cache_update(kc, k, idx)
            _cache_update(vc, v, idx)
            out = decode_attention(q, kc, vc, pos, window=w)
        new_cache = {"k": kc, "v": vc}
    else:
        positions = pos + torch.arange(s, device=x.device)
        if cfg.pos_emb == "rope":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        if mode == "prefill":
            out = qchunk_attention(q, k, v, window=spec.window)
            w = spec.window
            if w is not None:
                # the ring only needs min(window, cache_len) slots
                ring = w if cache_len is None else min(w, cache_len)
                if s >= ring:
                    kc, vc = k[:, s - ring:], v[:, s - ring:]  # slot=pos%W
                else:
                    kc, vc = _pad_seq(k, ring), _pad_seq(v, ring)
            else:
                kc, vc = _pad_seq(k, cache_len), _pad_seq(v, cache_len)
            new_cache = {"k": kc, "v": vc}
        elif mode == "train":
            out = full_attention(q, k, v, window=spec.window)
            new_cache = None
        else:
            raise ValueError(f"unknown mode {mode!r}")

    out = out.reshape(b, s, h * dh) @ p["wo"].to(dt)
    return out, new_cache
