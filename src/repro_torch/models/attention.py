"""GQA and MLA attention (PyTorch port of ``repro/models/attention.py``).

Three paths, as in the reference: ``full`` (materialised scores, train),
prefill, and ``decode`` (one query token per slot against a dense or
paged cache).  GQA prefill runs ``flash_attention`` — the hand-written
CUDA kernel on the card, its plain version on the CPU — where the
reference calls ``qchunk_attention``, which computes the same causal
(+window) attention; ``qchunk_attention`` stays as the oracle, and MLA
prefill keeps it (its qk and v head dims differ).  A sliding-window
prefill hands decode a ring of ``min(window, cache_len)`` slots with
position p in slot p % ring, the convention decode reads and writes.  On
the paged decode leg with ``pages["kernel"]`` set, attention runs in a
hand-written CUDA kernel that reads the pages in place through the block
table: ``paged_decode_attention`` for GQA, ``paged_mla_decode_attention``
for MLA's absorbed form (latent pools ``ckv``/``krope``, ``wv_b``
applied outside).

Caches are updated in place: a decode step writes the new token's K/V
into the pool it was given and returns the same tensors (the shape/dtype
contract of ``layers.check_cache_invariant``).  The cast points of the
reference are kept, because bf16 equality depends on them: probabilities
are cast to q's dtype before the PV product, decode divides by the
softmax sum after the bf16 PV product, and weights are cast to the
activation dtype at each use.  "prefill_chunk" (a cache-append chunk of a
chunked prefill) runs plain ``full_attention`` at the chunk's query offset,
as the reference does; the verify mode belongs to a later slice and
raises.
"""
from __future__ import annotations

import torch

from ..kernels import (flash_attention, paged_decode_attention,
                       paged_mla_decode_attention)
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
    """Forward-only prefill: loop over query chunks vs full K/V.

    Where ``s`` splits into ``n = max(1, s // chunk)`` equal chunks this
    is the reference's split; where it does not (1025 or 1537 positions
    at chunk 512), the port takes chunks of ``chunk`` queries and a short
    last one, where the reference asserts.  Each query row is computed
    the same way in both: the split only groups rows."""
    b, s, h, dh = q.shape
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    n = max(1, s // chunk)
    if n * (s // n) == s:
        chunk = s // n
    outs = []
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        bias = _mask_bias(c1 - c0, s, c0, window, q.device)
        outs.append(_sdpa(q[:, c0:c1], k, v, bias, scale))
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


def ring_from_prefill(t, ring):
    """The ring cache a prefill of S >= ``ring`` positions hands decode:
    the last ``ring`` positions of ``t`` (B, S, ...) with position p in
    slot p % ring, as decode writes (slot ``pos % ring``) and reads
    (``decode_attention``'s slot positions) the ring.  The reference keeps
    them unrolled (``t[:, S - ring:]``), which is the same only when
    S % ring == 0."""
    s = t.shape[1]
    return torch.roll(t[:, s - ring:], s % ring, dims=1)


def gqa_apply(x, p, cfg, spec, *, mode, pos, cache=None, cache_len=None,
              pages=None, attn_extent=None):
    """x: (B,S,D) -> (out, new_cache or None).  cache: {"k","v"}
    unexpanded.  With ``pages`` (decode) the K/V leaves are paged pools
    (P, page_size, Hkv, Dh): the new token's K/V is scattered through the
    block table, then attention reads a gathered dense view — or, with
    ``pages["kernel"]``, the pages in place in the CUDA kernel.
    "prefill_chunk" writes the chunk's K/V into the dense row cache at
    ``[pos, pos + S)`` (``pos`` a host int) and attends over its first
    ``attn_extent`` positions in plain ``full_attention``, as the
    reference does outside any kernel."""
    if mode == "verify":
        raise NotImplementedError(
            "gqa_apply mode 'verify' is not ported yet (ROADMAP.md queue 1, "
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
        if mode == "prefill_chunk":
            # cache-append chunk: masked key lanes add exact zeros, so any
            # extent >= pos + S gives the same rows; a linear cache is
            # required (``steps.chunkable``)
            kc, vc = cache["k"], cache["v"]
            kc[:, pos:pos + s] = k.to(kc.dtype)
            vc[:, pos:pos + s] = v.to(vc.dtype)
            ext = kc.shape[1] if attn_extent is None else attn_extent
            out = full_attention(q, kc[:, :ext], vc[:, :ext], q_off=pos)
            new_cache = {"k": kc, "v": vc}
        elif mode == "prefill":
            # the flash kernel on the card, its plain version on the CPU
            # (the reference runs qchunk_attention here: same function)
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True,
                                  window=spec.window)
            w = spec.window
            if w is not None:
                # the ring only needs min(window, cache_len) slots
                ring = w if cache_len is None else min(w, cache_len)
                if s >= ring:
                    kc = ring_from_prefill(k, ring)
                    vc = ring_from_prefill(v, ring)
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


# ====================================================================== MLA
def mla_param_shapes(cfg):
    """name -> (shape, init kind), the reference's layout."""
    d, h = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "ln": ((d,), "ones"),
        "wq_a": ((d, rq), "normal"),
        "q_ln": ((rq,), "ones"),
        "wq_b": ((rq, h * (dn + dr)), "normal"),
        "wkv_a": ((d, rkv + dr), "normal"),
        "kv_ln": ((rkv,), "ones"),
        "wk_b": ((rkv, h * dn), "normal"),
        "wv_b": ((rkv, h * dv), "normal"),
        "wo": ((h * dv, d), "normal"),
    }


def mla_cache_shapes(cfg, spec, batch, seq):
    del spec
    return {"ckv": (batch, seq, cfg.kv_lora_rank),
            "krope": (batch, seq, cfg.qk_rope_dim)}


def _mla_q(xn, p, cfg, dt):
    b, s, _ = xn.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    qa = rms_norm(xn @ p["wq_a"].to(dt), p["q_ln"], cfg.norm_eps)
    q = (qa @ p["wq_b"].to(dt)).view(b, s, h, dn + dr)
    return q[..., :dn], q[..., dn:]          # q_nope, q_rope


def mla_apply(x, p, cfg, spec, *, mode, pos, cache=None, cache_len=None,
              pages=None, attn_extent=None):
    """x: (B,S,D) -> (out, new_cache or None).  Decode runs the absorbed
    form (scores in the latent space, against the ``ckv``/``krope``
    caches, dense or paged); train, prefill and "prefill_chunk" the
    non-absorbed form (q/k dim nope + rope, v dim ``v_head_dim``) at the
    explicit scale ``(nope + rope)^-1/2``.  A chunk appends its latent to
    the dense row cache at ``[pos, pos + S)`` and rebuilds K/V from the
    cached latent of the first ``attn_extent`` positions."""
    if mode == "verify":
        raise NotImplementedError(
            "mla_apply mode 'verify' is not ported yet (ROADMAP.md queue 1, "
            "item 5: serve features past the main path)")
    b, s, _ = x.shape
    h = cfg.n_heads
    rkv, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                       cfg.v_head_dim)
    dt = x.dtype
    scale = (dn + dr) ** -0.5
    xn = rms_norm(x, p["ln"], cfg.norm_eps)

    q_nope, q_rope = _mla_q(xn, p, cfg, dt)
    kva = xn @ p["wkv_a"].to(dt)
    ckv = rms_norm(kva[..., :rkv], p["kv_ln"], cfg.norm_eps)   # (B,S,rkv)
    k_rope = kva[..., rkv:]                                    # (B,S,dr)

    if mode == "decode":
        pos = torch.as_tensor(pos, device=x.device)
        per_slot = pos.dim() == 1
        rp = pos[:, None] if per_slot else pos             # (B,1) | scalar
        q_rope = apply_rope(q_rope, rp, cfg.rope_theta)
        k_rope = apply_rope(k_rope[:, :, None, :], rp,
                            cfg.rope_theta)[:, :, 0, :]
        cc, kr = cache["ckv"], cache["krope"]
        fused = paged_leaf(pages, None) and pages.get("kernel")
        if paged_leaf(pages, None):
            table, ps = pages["table"], pages["page_size"]
            page_scatter(cc, table, ps, pos, ckv)
            page_scatter(kr, table, ps, pos, k_rope)
            if not fused:
                cd, kd = page_gather(cc, table, ps), page_gather(kr, table,
                                                                 ps)
        else:
            _cache_update(cc, ckv, pos)
            _cache_update(kr, k_rope, pos)
            cd, kd = cc, kr
        wk_b = p["wk_b"].to(dt).view(rkv, h, dn)
        # absorb q_nope through wk_b: (B,1,H,rkv)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, wk_b)
        if fused:
            pv = pos if per_slot else pos.expand(b)
            lat = paged_mla_decode_attention(
                q_lat.contiguous(), q_rope.contiguous(), cc, kr,
                table.int(), pv.int(), page_size=ps, scale=scale)
        else:
            scores = (torch.einsum("bshr,btr->bhst", q_lat, cd)
                      + torch.einsum("bshr,btr->bhst", q_rope, kd))
            scores = scores.float() * scale
            valid = torch.arange(cd.shape[1], device=x.device) <= rp
            mb = torch.where(valid, 0.0, NEG_INF).float()   # (B,T) | (T,)
            scores = scores + (mb[:, None, None, :] if per_slot
                               else mb[None, None, None, :])
            probs = torch.softmax(scores, dim=-1).to(dt)
            lat = torch.einsum("bhst,btr->bshr", probs, cd)  # (B,1,H,rkv)
        out = torch.einsum("bshr,rhv->bshv", lat,
                           p["wv_b"].to(dt).view(rkv, h, dv))
        new_cache = {"ckv": cc, "krope": kr}
    elif mode == "prefill_chunk":
        positions = pos + torch.arange(s, device=x.device)
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        k_rope = apply_rope(k_rope[:, :, None, :], positions,
                            cfg.rope_theta)[:, :, 0, :]
        cc, kr = cache["ckv"], cache["krope"]
        cc[:, pos:pos + s] = ckv.to(cc.dtype)
        kr[:, pos:pos + s] = k_rope.to(kr.dtype)
        sk = cc.shape[1] if attn_extent is None else attn_extent
        cs = cc[:, :sk].to(dt)
        k_nope = (cs @ p["wk_b"].to(dt)).view(b, sk, h, dn)
        vfull = (cs @ p["wv_b"].to(dt)).view(b, sk, h, dv)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, kr[:, :sk].to(dt)[:, :, None, :].expand(
            b, sk, h, dr)], dim=-1)
        out = full_attention(q, k, vfull, q_off=pos, scale=scale)
        new_cache = {"ckv": cc, "krope": kr}
    elif mode in ("train", "prefill"):
        positions = pos + torch.arange(s, device=x.device)
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        k_rope = apply_rope(k_rope[:, :, None, :], positions,
                            cfg.rope_theta)[:, :, 0, :]
        k_nope = (ckv @ p["wk_b"].to(dt)).view(b, s, h, dn)
        vfull = (ckv @ p["wv_b"].to(dt)).view(b, s, h, dv)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                      dim=-1)
        if mode == "prefill":
            out = qchunk_attention(q, k, vfull, scale=scale)
            new_cache = {"ckv": _pad_seq(ckv, cache_len),
                         "krope": _pad_seq(k_rope, cache_len)}
        else:
            out = full_attention(q, k, vfull, scale=scale)
            new_cache = None
    else:
        raise ValueError(f"unknown mode {mode!r}")

    out = out.reshape(b, s, h * dv) @ p["wo"].to(dt)
    return out, new_cache
