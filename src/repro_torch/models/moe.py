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
never asks).  Both are differentiable: the capacity dispatch's scatter
goes into a fresh zero buffer, and the gate product runs out of place
where autograd records it.

Under a mesh (the reference's layout, ``moe_param_shapes``: ``w_gate``
and ``w_up`` on ``("experts", "fsdp", "tp")``, ``w_down`` on
``("experts", "tp", "fsdp")``, ``"experts"`` on no mesh axis) every rank
holds every expert at its own d_ff columns, and routing is token-local,
so no all-to-all is needed:

* the router and the dispatch run the same on every model rank from the
  whole ``xn`` and the whole router (slots, capacity drops, the dropless
  sort and its host read of segment bounds): every rank picks the same
  experts;
* ``xn`` enters this rank's expert columns (``layers.tp_enter``), and so
  do the combine weights ``topv``: whole on every rank, they multiply
  this rank's partial outputs, so their gradient is a partial sum per
  rank;
* the rank's partial ``y`` (B, S, D) is summed over ``model`` once,
  after the sum over picks (``layers.tp_all_reduce``): a MoE layer takes
  one all-reduce a pass, as a dense MLP does, not the ``top_k`` times
  larger per-pick rows;
* the load-balance term comes from the whole ``probs``, so it is equal
  on every model rank and counted once.  In training on a data axis its
  expert fractions and mean probabilities are the global batch's, as
  GSPMD computes the reference's: each rank's means summed over ``data``
  (``sharding.fsdp.data_all_reduce``, whose backward is the identity)
  and divided by the axis (:func:`global_stats`).  Each rank then adds
  the same term and differentiates it through its own rows' ``probs``
  only, so the sum of the ranks' gradients is the global one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding.fsdp import data_all_reduce
from .layers import tp_all_reduce, tp_enter, tp_shards


def moe_param_shapes(cfg):
    """name -> (shape, logical axes, init kind), the reference's layout:
    experts stacked on the leading axis of each 3-D weight."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "ln": ((d,), (None,), "ones"),
        "router": ((d, e), ("fsdp", None), "normal"),
        "w_gate": ((e, d, f), ("experts", "fsdp", "tp"), "normal"),
        "w_up": ((e, d, f), ("experts", "fsdp", "tp"), "normal"),
        "w_down": ((e, f, d), ("experts", "tp", "fsdp"), "normal"),
    }


def capacity(seq: int, cfg) -> int:
    """Slots per expert and batch row for ``seq`` tokens."""
    c = int(seq * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cfg.top_k, c)


def router_probs(xn, router):
    """(B, S, E) f32 softmax of the router's gates."""
    gates = torch.einsum("bsd,de->bse", xn.float(), router.float())
    return torch.softmax(gates, dim=-1)


def global_stats(stats, mesh):
    """The load-balance term's per-expert means ``stats`` (this rank's
    rows) over the global batch: summed over ``data`` and divided by the
    axis (the ranks hold equal rows).  ``stats`` itself without a mesh
    or on a data axis of 1."""
    n = 1 if mesh is None else mesh.shape["data"]
    if n == 1:
        return stats
    return data_all_reduce(stats, mesh) / n


def route(xn, router, cfg, aux=True, data=None):
    """f32 router: softmax over experts, top-k, renormalised.  Returns
    (topv, topi, lb): (B, S, K) weights and expert ids, and the
    load-balance term (:func:`load_balance`; None unless ``aux``)."""
    probs = router_probs(xn, router)
    topv, topi = torch.topk(probs, cfg.top_k, dim=-1)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    return topv, topi, load_balance(probs, topi, cfg, data) if aux else None


def load_balance(probs, topi, cfg, data=None):
    """The Switch-style load-balance term ``E * sum_e f_e * p_e``: ``f_e``
    the share of tokens whose first pick is expert e, ``p_e`` its mean
    router probability, both over the global batch on ``data``'s data
    axis (:func:`global_stats`)."""
    e = cfg.n_experts
    frac = F.one_hot(topi[..., 0], e).float().mean(dim=(0, 1))
    frac, pmean = global_stats(
        torch.stack([frac, probs.mean(dim=(0, 1))]), data)
    return e * (frac * pmean).sum()


def enter(xn, topv):
    """``xn`` and the combine weights ``topv`` entering this rank's expert
    columns (``layers.tp_enter``: the identity, whose backward sums the
    gradient over ``model``)."""
    return tp_enter(xn), tp_enter(topv)


def dispatch_slots(topi, cfg, c):
    """Slot of each (token, pick) in its expert's queue, per batch row, in
    token-major, pick-minor order.  Returns (eid, slot, keep), each
    (B, S*K): a pick is kept when its slot is below ``c``."""
    b = topi.shape[0]
    eid = topi.reshape(b, -1)
    oh = F.one_hot(eid, cfg.n_experts)                    # (B, S*K, E)
    slot = ((oh.cumsum(dim=1) - oh) * oh).sum(dim=-1)
    return eid, slot, slot < c


def moe_mlp(xn, p, cfg, aux=True, data=None):
    """xn: (B, S, D) pre-normed; ``data``: the train mesh, whose data axis
    the load-balance term's means span.  Returns (y, lb)."""
    b, s, d = xn.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = xn.dtype
    topv, topi, lb = route(xn, p["router"], cfg, aux, data)
    split = tp_shards(cfg.d_ff, "tp") > 1
    if split:
        xn, topv = enter(xn, topv)
    c = capacity(s, cfg)
    eid, slot, keep = dispatch_slots(topi, cfg, c)
    slot_w = torch.where(keep, slot, c)                   # overflow -> pad
    brow = torch.arange(b, device=xn.device)[:, None]
    buf = xn.new_zeros((b, e, c + 1, d))
    # kept picks own distinct slots; only the dropped pad slot collides
    buf[brow, eid, slot_w] = xn.repeat_interleave(k, dim=1)
    xin = buf[:, :, :c].transpose(0, 1).reshape(e, b * c, d)
    h = F.silu(torch.bmm(xin, p["w_gate"].to(dt)))
    u = torch.bmm(xin, p["w_up"].to(dt))
    # in place only where autograd records nothing: the product's
    # backward needs the gate's value as it was
    h = h.mul_(u) if not torch.is_grad_enabled() else h * u
    del u
    out_e = torch.bmm(h, p["w_down"].to(dt)).view(e, b, c, d)
    del h
    got = out_e[eid, brow, slot.clamp(0, c - 1)]          # gather back
    got = got * keep[..., None].to(dt)
    w = topv.reshape(b, s * k).to(dt)[..., None]
    y = (got * w).view(b, s, k, d).sum(dim=2)
    return (tp_all_reduce(y) if split else y), lb


class DroplessOnMeta(RuntimeError):
    """The dropless MoE on meta tensors: its segment bounds are data that
    a meta tensor does not hold, and no routing is made up for it."""


def moe_mlp_ragged(xn, p, cfg, aux=True, data=None):
    """Dropless variant: (token, pick) rows sorted by expert, one matmul
    per expert's contiguous segment.  The segment bounds are read on the
    host (``DroplessOnMeta`` on meta tensors); under a mesh every model
    rank reads the same bounds.  Returns (y, lb)."""
    if xn.device.type == "meta":
        raise DroplessOnMeta(
            f"{cfg.name}: moe_impl='ragged' reads each expert's segment "
            "bounds on the host, and a meta tensor holds no routing; dry-run "
            "it with moe_impl='onehot'")
    b, s, d = xn.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = xn.dtype
    topv, topi, lb = route(xn, p["router"], cfg, aux, data)
    split = tp_shards(cfg.d_ff, "tp") > 1
    if split:
        xn, topv = enter(xn, topv)
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
    return (tp_all_reduce(y) if split else y), lb
