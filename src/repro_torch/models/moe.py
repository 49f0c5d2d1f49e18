"""Top-k MoE MLP (PyTorch port of ``repro/models/moe.py``).

Two dispatches, as in the reference:

  * ``moe_mlp`` — GShard-style capacity dispatch per batch row: each
    (token, pick) takes the next slot of its expert's queue in token-major,
    pick-minor order; picks past ``capacity`` overflow into a pad slot
    that is dropped.  Dispatch and combine are scatter / gather, never a
    one-hot matmul.
  * ``moe_mlp_ragged`` — dropless: (token, pick) rows sorted by expert
    (stable), one ``torch.matmul`` per expert over its contiguous segment
    (the reference's ``lax.ragged_dot``).

The expert products are plain matrix products, outside any kernel in the
reference too, so they go to ``torch.bmm`` / ``torch.matmul`` here.  Both
return ``(y, lb)`` as the reference does; the Switch-style load-balance
term ``lb`` is computed only when asked for (training; the serve path
never asks).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_param_shapes(cfg):
    """name -> (shape, init kind), the reference's layout: experts
    stacked on the leading axis of each 3-D weight."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "ln": ((d,), "ones"),
        "router": ((d, e), "normal"),
        "w_gate": ((e, d, f), "normal"),
        "w_up": ((e, d, f), "normal"),
        "w_down": ((e, f, d), "normal"),
    }


def capacity(seq: int, cfg) -> int:
    """Slots per expert and batch row for ``seq`` tokens."""
    c = int(seq * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cfg.top_k, c)


def router_probs(xn, router):
    """(B, S, E) f32 softmax of the router's gates."""
    gates = torch.einsum("bsd,de->bse", xn.float(), router.float())
    return torch.softmax(gates, dim=-1)


def route(xn, router, cfg, aux=True):
    """f32 router: softmax over experts, top-k, renormalised.  Returns
    (topv, topi, lb): (B, S, K) weights and expert ids, and the
    load-balance term ``E * sum_e f_e * p_e`` (None unless ``aux``)."""
    probs = router_probs(xn, router)
    topv, topi = torch.topk(probs, cfg.top_k, dim=-1)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    lb = None
    if aux:
        e = cfg.n_experts
        frac = F.one_hot(topi[..., 0], e).float().mean(dim=(0, 1))
        lb = e * (frac * probs.mean(dim=(0, 1))).sum()
    return topv, topi, lb


def dispatch_slots(topi, cfg, c):
    """Slot of each (token, pick) in its expert's queue, per batch row, in
    token-major, pick-minor order.  Returns (eid, slot, keep), each
    (B, S*K): a pick is kept when its slot is below ``c``."""
    b = topi.shape[0]
    eid = topi.reshape(b, -1)
    oh = F.one_hot(eid, cfg.n_experts)                    # (B, S*K, E)
    slot = ((oh.cumsum(dim=1) - oh) * oh).sum(dim=-1)
    return eid, slot, slot < c


def moe_mlp(xn, p, cfg, aux=True):
    """xn: (B, S, D) pre-normed.  Returns (y, lb)."""
    b, s, d = xn.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = xn.dtype
    topv, topi, lb = route(xn, p["router"], cfg, aux)
    c = capacity(s, cfg)
    eid, slot, keep = dispatch_slots(topi, cfg, c)
    slot_w = torch.where(keep, slot, c)                   # overflow -> pad
    brow = torch.arange(b, device=xn.device)[:, None]
    buf = xn.new_zeros((b, e, c + 1, d))
    # kept picks own distinct slots; only the dropped pad slot collides
    buf[brow, eid, slot_w] = xn.repeat_interleave(k, dim=1)
    xin = buf[:, :, :c].transpose(0, 1).reshape(e, b * c, d)
    h = F.silu(torch.bmm(xin, p["w_gate"].to(dt)))
    h.mul_(torch.bmm(xin, p["w_up"].to(dt)))
    out_e = torch.bmm(h, p["w_down"].to(dt)).view(e, b, c, d)
    del h
    got = out_e[eid, brow, slot.clamp(0, c - 1)]          # gather back
    got = got * keep[..., None].to(dt)
    w = topv.reshape(b, s * k).to(dt)[..., None]
    y = (got * w).view(b, s, k, d).sum(dim=2)
    return y, lb


def moe_mlp_ragged(xn, p, cfg, aux=True):
    """Dropless variant: (token, pick) rows sorted by expert, one matmul
    per expert's contiguous segment.  The segment bounds are read on the
    host.  Returns (y, lb)."""
    b, s, d = xn.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = xn.dtype
    topv, topi, lb = route(xn, p["router"], cfg, aux)
    eid = topi.reshape(-1)
    order = torch.argsort(eid, stable=True)
    xs = xn.reshape(b * s, d).repeat_interleave(k, dim=0)[order]
    bounds = [0] + torch.bincount(eid, minlength=e).cumsum(0).tolist()
    out = torch.empty_like(xs)
    for i in range(e):
        lo, hi = bounds[i], bounds[i + 1]
        if hi > lo:
            seg = xs[lo:hi]
            h = F.silu(seg @ p["w_gate"][i].to(dt)) * (seg @ p["w_up"][i]
                                                       .to(dt))
            out[lo:hi] = h @ p["w_down"][i].to(dt)
    out = out[torch.argsort(order)]
    w = topv.reshape(-1).to(dt)[:, None]
    y = (out * w).view(b, s, k, d).sum(dim=2)
    return y, lb
