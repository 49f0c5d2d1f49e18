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
as the reference does.  "verify" (speculative decoding) appends a window
of S tokens per slot and scores every lane against the cache, causally
within the window; a paged leaf takes the gather path there, as in the
reference (scatter the window, ``page_gather``, plain attention).

Tensor parallelism (under a mesh: ``models.layers.tp_heads``): a head
count the model axis ``n`` divides is split, ``H/n`` query or ``Hkv/n``
KV heads a rank; one it does not divide is whole on every rank, as the
reference's strict rules replicate it (``"heads"`` / ``"kv_heads"``
resolve to no axis).  The weights stay cut by the rules whatever the
heads do (``steps.tp_splits``): ``wq``/``wk``/``wv``'s columns and
``wo``'s rows split over model wherever their width divides, mid-head
included (qwen2.5-14b on 16: 2.5 query heads' and half a KV head's
columns a rank), so per-device weight bytes are the rules'.  Each rank
then runs every path above on the heads it holds (the flash prefill, the
paged decode kernel, verify) and one all-reduce after ``wo`` where
``wo``'s rows are cut.  Heads are kv-head-major, so an even split keeps
each query head on the rank that holds its KV group (the reference's
reasoning, ``repro/models/attention.py:355-371``); where the query heads
split and the KV heads do not (mixtral on 16: rank r's query heads 2r
and 2r + 1 read KV head r // 2 of the whole pool), the rank's query
heads read a view of just their KV head (``Heads.reads``), which the
paged kernel reads in place through the pool's strides.

How whole heads are made from mid-head columns is chosen per family.
GQA gathers the projected activations' columns (``layers.
tp_gather_cols``: q, k and v in one collective, the bias added before,
RoPE after): a decode tick moves ``B (H + 2 Hkv) dh`` values, far less
than the weights.  MLA gathers ``wq_b``, ``wk_b`` and ``wv_b``'s columns
once a forward instead: its absorbed decode multiplies q by ``wk_b``
per head, so ``wk_b`` must be whole per head, and its latents
(``wq_a``, ``wkv_a``, ``ckv``, ``krope``) are whole on every rank
already.  Where every rank computes whole heads and ``wo``'s rows are
cut, each rank narrows the attention output to its rows of ``wo``
(qwen2.5-14b on 16: 320 of 5120) before the all-reduce; where ``wo`` is
not cut either (40 heads on 3 ranks: 5120 rows do not split 3 ways),
the whole output comes out on every rank with no collective.  MLA splits
its query heads as GQA does where they divide and keeps its latents
whole on every rank.  Query heads whose split would give a rank heads
of uneven KV groups are whole on every rank too (no ``REGISTRY`` family
on 16).

In training (``layers.tp_enter``, whose backward all-reduces the
gradient over ``model``): GQA enters the normed ``xn`` once before
``wq``/``wk``/``wv``, so ``xn``'s gradient, each rank's a sum over its
own heads, is summed whole.  MLA's ``wq_a``/``wkv_a`` path is whole on
every rank, so it enters where each of its tensors first meets the local
heads: the normed q latent before ``wq_b``, ``ckv`` before
``wk_b``/``wv_b``, and the roped shared ``k_rope``, which every local
head reads.  The gradients of ``wq_a``, ``wkv_a``, ``q_ln`` and ``kv_ln``
then come out whole and equal on every model rank, and so does ``xn``'s:
an enter of ``xn`` as well would sum that whole gradient once per rank.
The three latents are also narrower than ``xn`` (768 + 256 + 32 against
2560 columns on minicpm3-4b).

Whole heads in training keep the gradient whole by the same rule: a
tensor whole and equal on every rank enters (``tp_enter``) exactly where
a rank goes on with only its own part of it.  ``xn`` enters only the
products with a weight's cut columns (a product with a whole weight
gives every rank the whole gradient already); the whole attention output
enters before it narrows to the rank's rows of ``wo``, so its gradient,
each rank's zero outside its own columns, is summed whole before the
whole attention's backward; the whole K and V enter before a rank's
query heads read their view of them.  A gather of columns (activations
or MLA's weights) then keeps this rank's block of a gradient that is
whole and equal on every rank, which is its backward.
"""
from __future__ import annotations

import torch

from ..kernels import (flash_attention, paged_decode_attention,
                       paged_mla_decode_attention)
from .layers import (apply_rope, page_gather, page_scatter,
                     page_scatter_window, rms_norm, tp_all_reduce, tp_coord,
                     tp_enter, tp_gather_cols, tp_heads, tp_shards)

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


def verify_attention(q, k_cache, v_cache, pos, *, scale=None):
    """Speculative-decode verify: q (B,S,H,Dh), lane j of slot b at
    position ``pos_b + j``; caches (B,Sc,Hkv,Dh) already holding the
    window's K/V (linear caches only: ``steps.speculatable``).

    The reference's formulation, :func:`decode_attention`'s partial
    softmax (f32 scores, the PV product on unnormalised probabilities in
    q's dtype, the sum divided at the end) under a per-lane causal mask.
    Where the reference expands K/V to H heads, the port groups each KV
    head's ``H / Hkv`` query heads and S lanes into one block of rows
    ``(B, Hkv, group * S, Dh)`` (flat head h reads KV head h // group, as
    ``_expand_kv``), so K/V are read as stored, never copied per query
    head: the same dot products, summed in another order."""
    b, s, h, dh = q.shape
    sc, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, dh).permute(0, 2, 3, 1, 4).reshape(
        b, hkv, g * s, dh)                          # rows (head r, lane j)
    pos = torch.as_tensor(pos, device=q.device)
    qp = pos[:, None] + torch.arange(s, device=q.device)          # (B,S)
    valid = (torch.arange(sc, device=q.device)[None, None, :]
             <= qp[:, :, None])                                   # (B,S,Sc)
    bias = torch.where(valid, 0.0, NEG_INF).float()[:, None, None]
    scale = (dh ** -0.5) if scale is None else scale
    scores = torch.einsum("bgrd,bkgd->bgrk", qg, k_cache).float()
    scores = scores.view(b, hkv, g, s, sc) * scale + bias
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bgrk,bkgd->bgrd",
                       p.to(q.dtype).view(b, hkv, g * s, sc), v_cache)
    out = out.view(b, hkv, g, s, dh) / l.to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh)


# ====================================================================== GQA
def gqa_param_shapes(cfg):
    """Flat (d, H*dh) weights, as the reference stores them: name ->
    (shape, logical axes, init kind), the reference's table
    (``repro/models/attention.py::gqa_param_shapes``)."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {
        "ln": ((d,), (None,), "ones"),
        "wq": ((d, h * dh), ("fsdp", "tp"), "normal"),
        "wk": ((d, hkv * dh), ("fsdp", "tp"), "normal"),
        "wv": ((d, hkv * dh), ("fsdp", "tp"), "normal"),
        "wo": ((h * dh, d), ("tp", "fsdp"), "normal"),
    }
    if cfg.qkv_bias:
        shapes["bq"] = ((h * dh,), ("tp",), "zeros")
        shapes["bk"] = ((hkv * dh,), ("tp",), "zeros")
        shapes["bv"] = ((hkv * dh,), ("tp",), "zeros")
    return shapes


def gqa_cache_shapes(cfg, spec, batch, seq):
    """name -> (shape, logical axes)."""
    sc = min(seq, spec.window) if spec.window else seq
    kv = (batch, sc, cfg.n_kv_heads, cfg.head_dim)
    ax = ("batch", "seq_shard", "kv_heads", None)
    return {"k": (kv, ax), "v": (kv, ax)}


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


def _cache_update_window(c, u, pos, n_tok):
    """Dense-cache counterpart of ``page_scatter_window``: write the verify
    window ``u`` (B,S,...) into cache ``c`` (B,Sc,...) at per-slot
    positions ``pos_b + j`` for lanes ``j < n_tok_b``, in place.

    The reference sends masked lanes past the cache extent, where JAX's
    scatter drops them; ``index_put_`` raises on such an index instead.
    Here a masked lane writes back the value it finds at position
    ``(pos_b + j) % Sc``: read before the write, so the cache is left as
    it was there.  With S <= Sc a slot's lanes name distinct positions, so
    no masked lane shares a position with a valid one."""
    b, s = u.shape[:2]
    if s > c.shape[1]:
        raise ValueError(f"verify window {s} longer than the cache "
                         f"{c.shape[1]}")
    lane = torch.arange(s, device=c.device)
    idx = (torch.as_tensor(pos, device=c.device).long()[:, None] + lane) \
        % c.shape[1]                                              # (B,S)
    valid = lane[None, :] < torch.as_tensor(n_tok, device=c.device)[:, None]
    rows = torch.arange(b, device=c.device)[:, None]
    keep = c[rows, idx]
    valid = valid.view((b, s) + (1,) * (c.dim() - 2))
    c[rows, idx] = torch.where(valid, u.to(c.dtype), keep)
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
              pages=None, attn_extent=None, n_tok=None):
    """x: (B,S,D) -> (out, new_cache or None).  cache: {"k","v"}
    unexpanded.  With ``pages`` (decode) the K/V leaves are paged pools
    (P, page_size, Hkv, Dh): the new token's K/V is scattered through the
    block table, then attention reads a gathered dense view — or, with
    ``pages["kernel"]``, the pages in place in the CUDA kernel.
    "prefill_chunk" writes the chunk's K/V into the dense row cache at
    ``[pos, pos + S)`` (``pos`` a host int) and attends over its first
    ``attn_extent`` positions in plain ``full_attention``, as the
    reference does outside any kernel.  "verify" appends the (B,S) window
    at per-slot positions ``pos`` (B,), lanes ``>= n_tok`` masked, and
    scores every lane (:func:`verify_attention`)."""
    b, s, _ = x.shape
    hd = tp_heads(cfg.n_heads, cfg.n_kv_heads)     # whole off a mesh
    h, hkv, dh = hd.h, hd.hkv, cfg.head_dim
    q_cut = tp_shards(cfg.n_heads * dh) > 1        # wq's columns, wo's rows
    kv_cut = tp_shards(cfg.n_kv_heads * dh) > 1
    dt = x.dtype
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    # a product with this rank's columns of a weight takes xn entered (its
    # gradient there is this rank's partial sum); one with a whole weight
    # takes xn as it is (its gradient is whole on every rank)
    xe = tp_enter(xn) if q_cut or kv_cut else xn

    def proj(w, bias, cut):
        y = (xe if cut else xn) @ p[w].to(dt)
        return y + p[bias].to(dt) if cfg.qkv_bias else y

    cols = [proj("wq", "bq", q_cut), proj("wk", "bk", kv_cut),
            proj("wv", "bv", kv_cut)]
    # columns cut mid-head where the heads are whole on every rank: the
    # rank's columns (bias added: it is per column) gathered whole, in one
    # collective; RoPE pairs columns within a head, so it comes after
    q_mid = q_cut and h == cfg.n_heads
    kv_mid = kv_cut and hkv == cfg.n_kv_heads
    mid = [i for i, m in enumerate((q_mid, kv_mid, kv_mid)) if m]
    if mid:
        for i, t in zip(mid, tp_gather_cols(*(cols[i] for i in mid))):
            cols[i] = t
    q = cols[0].view(b, s, h, dh)
    k = cols[1].view(b, s, hkv, dh)
    v = cols[2].view(b, s, hkv, dh)
    first, count = hd.reads

    def reads(t):
        """The KV heads (dim 2) this rank's query heads read; entered,
        since every rank reads only its own of a tensor whole on all."""
        if count == t.shape[2]:
            return t
        return tp_enter(t).narrow(2, first, count)

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
                # the kernel reads a view of the pool's heads in place
                pv = pos if pos.dim() == 1 else pos.expand(b)
                out = paged_decode_attention(
                    q.contiguous(), reads(kc), reads(vc), table.int(),
                    pv.int(), page_size=ps, window=w)
            else:
                out = decode_attention(q, page_gather(reads(kc), table, ps),
                                       page_gather(reads(vc), table, ps),
                                       pos, window=w)
        else:
            idx = torch.remainder(pos, kc.shape[1]) if w is not None else pos
            _cache_update(kc, k, idx)
            _cache_update(vc, v, idx)
            out = decode_attention(q, reads(kc), reads(vc), pos, window=w)
        new_cache = {"k": kc, "v": vc}
    elif mode == "verify":
        # a linear cache (steps.speculatable): logical index == position;
        # the paged leaf scatters the window and reads a gathered view,
        # as the reference does — the paged kernel is a one-query decode
        pos = torch.as_tensor(pos, device=x.device)
        qp = pos[:, None] + torch.arange(s, device=x.device)     # (B,S)
        if cfg.pos_emb == "rope":
            q = apply_rope(q, qp, cfg.rope_theta)
            k = apply_rope(k, qp, cfg.rope_theta)
        kc, vc = cache["k"], cache["v"]
        if paged_leaf(pages, spec.window):
            table, ps = pages["table"], pages["page_size"]
            page_scatter_window(kc, table, ps, pos, k, n_tok)
            page_scatter_window(vc, table, ps, pos, v, n_tok)
            out = verify_attention(q, page_gather(reads(kc), table, ps),
                                   page_gather(reads(vc), table, ps), pos)
        else:
            _cache_update_window(kc, k, pos, n_tok)
            _cache_update_window(vc, v, pos, n_tok)
            out = verify_attention(q, reads(kc), reads(vc), pos)
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
            out = full_attention(q, reads(kc[:, :ext]), reads(vc[:, :ext]),
                                 q_off=pos)
            new_cache = {"k": kc, "v": vc}
        elif mode == "prefill":
            # the flash kernel on the card, its plain version on the CPU
            # (the reference runs qchunk_attention here: same function)
            out = flash_attention(q.contiguous(), reads(k).contiguous(),
                                  reads(v).contiguous(), causal=True,
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
            out = full_attention(q, reads(k), reads(v), window=spec.window)
            new_cache = None
        else:
            raise ValueError(f"unknown mode {mode!r}")

    return _out_proj(out.reshape(b, s, h * dh), p["wo"].to(dt), q_cut,
                     h == cfg.n_heads), new_cache


def _out_proj(out, wo, cut, whole):
    """The output projection: ``out`` (this rank's heads, or all of them
    where ``whole``) through ``wo``.  With ``wo``'s rows cut over model
    (``cut``) the products are partial and one all-reduce sums them;
    whole heads then first narrow to this rank's rows, entered (each
    rank's gradient there holds only its own columns, and the whole
    attention behind it needs the sum).  An uncut ``wo`` takes whole
    heads to the whole output on every rank, with no collective."""
    if cut and whole:
        c = wo.shape[0]
        out = tp_enter(out).narrow(-1, tp_coord("tp") * c, c)
    y = out @ wo
    return tp_all_reduce(y) if cut else y


# ====================================================================== MLA
def mla_param_shapes(cfg):
    """name -> (shape, logical axes, init kind), the reference's table."""
    d, h = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "ln": ((d,), (None,), "ones"),
        "wq_a": ((d, rq), ("fsdp", None), "normal"),
        "q_ln": ((rq,), (None,), "ones"),
        "wq_b": ((rq, h * (dn + dr)), (None, "tp"), "normal"),
        "wkv_a": ((d, rkv + dr), ("fsdp", None), "normal"),
        "kv_ln": ((rkv,), (None,), "ones"),
        "wk_b": ((rkv, h * dn), (None, "tp"), "normal"),
        "wv_b": ((rkv, h * dv), (None, "tp"), "normal"),
        "wo": ((h * dv, d), ("tp", "fsdp"), "normal"),
    }


def mla_cache_shapes(cfg, spec, batch, seq):
    """name -> (shape, logical axes): the latents carry no head dim."""
    del spec
    return {"ckv": ((batch, seq, cfg.kv_lora_rank),
                    ("batch", "seq_shard", None)),
            "krope": ((batch, seq, cfg.qk_rope_dim),
                      ("batch", "seq_shard", None))}


def _mla_q(xn, p, cfg, dt, h, wq_b):
    b, s, _ = xn.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    qa = rms_norm(xn @ p["wq_a"].to(dt), p["q_ln"], cfg.norm_eps)
    if h < cfg.n_heads:                 # the latent meets the local heads
        qa = tp_enter(qa)
    q = (qa @ wq_b).view(b, s, h, dn + dr)
    return q[..., :dn], q[..., dn:]          # q_nope, q_rope


def _mla_up(p, cfg, dt, h):
    """``wq_b``, ``wk_b`` and ``wv_b`` in ``dt`` for this rank's ``h``
    heads.  Where the heads are whole on every rank but a weight's
    columns are cut over model (mid-head), its columns are gathered
    whole, all of them in one collective once a forward: the absorbed
    decode needs ``wk_b`` whole per head, and every rank then runs the
    whole attention."""
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    ws = {k: p[k].to(dt) for k in ("wq_b", "wk_b", "wv_b")}
    if h == cfg.n_heads:
        whole = {"wq_b": h * (dn + dr), "wk_b": h * dn, "wv_b": h * dv}
        cut = [k for k in ws if tp_shards(whole[k]) > 1]
        if cut:
            for k, t in zip(cut, tp_gather_cols(*(ws[k] for k in cut))):
                ws[k] = t
    return ws


def mla_apply(x, p, cfg, spec, *, mode, pos, cache=None, cache_len=None,
              pages=None, attn_extent=None, n_tok=None):
    """x: (B,S,D) -> (out, new_cache or None).  Decode runs the absorbed
    form (scores in the latent space, against the ``ckv``/``krope``
    caches, dense or paged); train, prefill and "prefill_chunk" the
    non-absorbed form (q/k dim nope + rope, v dim ``v_head_dim``) at the
    explicit scale ``(nope + rope)^-1/2``.  A chunk appends its latent to
    the dense row cache at ``[pos, pos + S)`` and rebuilds K/V from the
    cached latent of the first ``attn_extent`` positions.  "verify" runs
    the absorbed decode form over the window's S lanes (positions ``pos_b
    + j``, lanes ``>= n_tok`` not written), as the reference does."""
    b, s, _ = x.shape
    h = tp_heads(cfg.n_heads).h                    # whole off a mesh
    split = h < cfg.n_heads
    rkv, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                       cfg.v_head_dim)
    dt = x.dtype
    scale = (dn + dr) ** -0.5
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    ws = _mla_up(p, cfg, dt, h)

    q_nope, q_rope = _mla_q(xn, p, cfg, dt, h, ws["wq_b"])
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
        wk_b = ws["wk_b"].view(rkv, h, dn)
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
                           ws["wv_b"].view(rkv, h, dv))
        new_cache = {"ckv": cc, "krope": kr}
    elif mode == "verify":
        # the absorbed decode form over S lanes, with a per-lane mask; the
        # paged leaf takes the gather path, as in the reference
        pos = torch.as_tensor(pos, device=x.device)
        qp = pos[:, None] + torch.arange(s, device=x.device)     # (B,S)
        q_rope = apply_rope(q_rope, qp, cfg.rope_theta)
        k_rope = apply_rope(k_rope[:, :, None, :], qp,
                            cfg.rope_theta)[:, :, 0, :]
        cc, kr = cache["ckv"], cache["krope"]
        if paged_leaf(pages, None):
            table, ps = pages["table"], pages["page_size"]
            page_scatter_window(cc, table, ps, pos, ckv, n_tok)
            page_scatter_window(kr, table, ps, pos, k_rope, n_tok)
            cd, kd = page_gather(cc, table, ps), page_gather(kr, table, ps)
        else:
            _cache_update_window(cc, ckv, pos, n_tok)
            _cache_update_window(kr, k_rope, pos, n_tok)
            cd, kd = cc, kr
        wk_b = ws["wk_b"].view(rkv, h, dn)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, wk_b)   # (B,S,H,rkv)
        scores = (torch.einsum("bshr,btr->bhst", q_lat, cd)
                  + torch.einsum("bshr,btr->bhst", q_rope, kd))
        scores = scores.float() * scale
        valid = (torch.arange(cd.shape[1], device=x.device)[None, None, :]
                 <= qp[:, :, None])                              # (B,S,T)
        scores = scores + torch.where(valid, 0.0, NEG_INF).float()[:, None]
        probs = torch.softmax(scores, dim=-1).to(dt)
        lat = torch.einsum("bhst,btr->bshr", probs, cd)          # (B,S,H,rkv)
        out = torch.einsum("bshr,rhv->bshv", lat,
                           ws["wv_b"].view(rkv, h, dv))
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
        k_nope = (cs @ ws["wk_b"]).view(b, sk, h, dn)
        vfull = (cs @ ws["wv_b"]).view(b, sk, h, dv)
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
        if split:                       # the latents meet the local heads
            ckv, k_rope = tp_enter(ckv), tp_enter(k_rope)
        k_nope = (ckv @ ws["wk_b"]).view(b, s, h, dn)
        vfull = (ckv @ ws["wv_b"]).view(b, s, h, dv)
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

    return _out_proj(out.reshape(b, s, h * dv), p["wo"].to(dt),
                     tp_shards(cfg.n_heads * dv) > 1, not split), new_cache
