"""Mamba2 (SSD, state-space duality) mixer (PyTorch port of
``repro/models/ssm.py``).

Train and prefill run the chunked SSD form; decode is the O(1) recurrent
update.  The scan goes through the SSD kernel's wrapper
(``repro_torch.kernels.ssd_scan``: the hand-written CUDA kernel on the
card, its plain version ``ssd_chunked`` on the CPU); in train mode on the
card it runs as ``SSDScanFn``, whose backward is the CUDA backward kernel
(``csrc/ssd_chunk_bwd.cu``).  The reference model
calls ``ssd_chunked`` itself, with the state carried in the activation
dtype; the kernel carries it in f32 and its ``h_final`` is cast to the
activation dtype — the same numbers in f32, within bf16 rounding in bf16.

The SSM cache (conv tail + recurrent state) is O(1) per slot and never
paged.  Decode writes both leaves in place (the port's forward keeps the
same cache tensors); chunked prefill raises, as in the reference.

Tensor parallelism (under a mesh: ``models.layers.tp_ssm_heads`` on
``ssm_heads``; a head count the model axis does not divide raises,
ROADMAP item 20b): each rank holds ``H/n`` heads — their ``d_inner/n``
channels of ``z`` and ``x``, their ``dt``, ``A_log``, ``Dskip`` and
``norm_w`` entries, their rows of ``out_proj`` and their state — and all
of B and C.  Layout deviation from the reference, which shards
``wxBC``'s whole ``conv_dim`` column-wise (``repro/models/ssm.py:26-27``)
and so would split mamba2's one group of B and C across ranks: here each
rank keeps its heads' x channels and every B and C channel, replicated
(:data:`TP_LOCAL`, cut by ``steps.tp_splits``), and the scan reads them
with its group stride 0 as it does on one device.  The same numbers; the
``conv`` leaf's bytes per rank are ``(d_inner/n + 2 N G) / conv_dim`` of
the whole, not 1/n.  The gated norm normalises over the whole ``d_inner``:
the f32 sum of squares of the local channels is all-reduced and the
kernel applies that statistic (``layers.gated_rms_norm(width=)``).  One
all-reduce after ``out_proj``.

In training (``layers.tp_enter``: identity forward, all-reduce over
``model`` backward), the layout has a trap: ``xn @ wxBC`` yields this
rank's x channels and the whole of B and C, and each rank reads B and C
only through its own heads, so its gradient of B and C is a partial sum
over its heads.  The choice made here: ``xn`` enters the mixer once
(before ``wz``, ``wxBC`` and ``wdt``), which sums ``xn``'s gradient over
the ranks, the B/C path's partials with the rest, each exactly once; and
the B and C columns of ``wxBC``, ``conv_w`` and ``conv_b`` enter too
(:func:`bc_shared` on the compute copy of those columns), so their
weight gradients are summed over ``model`` exactly once and come out
whole and equal on every rank, as the columns themselves are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ssd_scan
from .layers import (gated_rms_norm, rms_norm, tp_all_reduce, tp_coord,
                     tp_enter, tp_ssm_heads)


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


# The port's tensor-parallel layout of the mixer's leaves that the
# reference's logical axes do not give (params and the ``conv`` cache
# leaf): leaf name -> what its last dim holds.  "conv": conv_dim channels
# (a rank keeps its heads' x channels and all of B and C); "heads": one
# entry per head; "inner": d_inner channels.  The other leaves follow
# their logical axes (``wz`` and ``out_proj`` on "tp", ``state`` on
# "ssm_heads"), which cut the same heads' channels.
TP_LOCAL = {"wxBC": "conv", "conv_w": "conv", "conv_b": "conv",
            "conv": "conv", "wdt": "heads", "dt_bias": "heads",
            "A_log": "heads", "Dskip": "heads", "norm_w": "inner"}


def tp_local_width(name, cfg, n: int) -> int:
    """The last dim of a rank's ``name`` leaf under :data:`TP_LOCAL`."""
    kind = TP_LOCAL[name]
    return {"heads": cfg.ssm_nheads // n, "inner": cfg.d_inner // n,
            "conv": conv_dim(cfg) - cfg.d_inner + cfg.d_inner // n}[kind]


def bc_shared(t):
    """The B and C columns of a mixer weight (the compute copy) where
    every model rank holds them whole: their gradient, each rank's a sum
    over its own heads, is summed over ``model`` (``layers.tp_enter``).
    Looked up at each call."""
    return tp_enter(t)


def _with_bc_shared(w, di):
    """``w`` (last dim: this rank's ``di`` x channels, then B and C) with
    its B and C columns through :func:`bc_shared`."""
    return torch.cat([w[..., :di], bc_shared(w[..., di:])], dim=-1)


def ssm_param_shapes(cfg):
    """name -> (shape, logical axes, init kind), the reference's table."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    cd = conv_dim(cfg)
    return {
        "ln": ((d,), (None,), "ones"),
        "wz": ((d, di), ("fsdp", "tp"), "normal"),
        "wxBC": ((d, cd), ("fsdp", "tp"), "normal"),
        "wdt": ((d, h), ("fsdp", None), "normal"),
        "dt_bias": ((h,), (None,), "dt_bias"),
        "A_log": ((h,), (None,), "A_log"),
        "Dskip": ((h,), (None,), "ones"),
        "conv_w": ((cfg.ssm_conv, cd), (None, "conv_dim"), "normal"),
        "conv_b": ((cd,), ("conv_dim",), "zeros"),
        "norm_w": ((di,), (None,), "ones"),
        "out_proj": ((di, d), ("tp", "fsdp"), "normal"),
    }


def ssm_cache_shapes(cfg, spec, batch, seq):
    """name -> (shape, logical axes)."""
    del spec, seq
    h, p, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    return {"conv": ((batch, cfg.ssm_conv - 1, conv_dim(cfg)),
                     ("batch", None, "conv_dim")),
            "state": ((batch, h, p, n), ("batch", "ssm_heads", None, None))}


def _causal_conv(xbc, w, bias):
    """Depthwise causal conv by shifted adds. xbc: (B,S,C), w: (W,C)."""
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + bias)


def ssd_chunked(xs, dt, a_coef, b_in, c_in, chunk, init_state):
    """Chunked SSD scan (plain version; a Python loop over chunks takes
    the place of ``lax.scan``).

    xs: (B,S,H,P) values; dt: (B,S,H) f32 step sizes; a_coef: (H,)
    negative; b_in/c_in: (B,S,H,N).  Returns (y: (B,S,H,P), final state
    (B,H,P,N) in the dtype the carry promotes to from ``init_state``).

    Where ``s`` splits into ``max(1, s // chunk)`` equal chunks this is
    the reference's split; where it does not (17 positions at chunk 8),
    the port takes chunks of ``chunk`` positions and a short last one,
    where the reference asserts: the last chunk is padded with dt 0 and
    x 0, which add nothing to the state or to y (the SSD kernel's rule),
    and the padded rows of y are dropped."""
    b, s, h, p = xs.shape
    nc = max(1, s // chunk)
    q = s // nc
    if nc * q != s:
        q, nc = chunk, -(-s // chunk)
        pad = nc * q - s
        xs, dt, b_in, c_in = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                              for t in (xs, dt, b_in, c_in))

    def r(t):
        return t.reshape(b, nc, q, *t.shape[2:])

    xs, dt, b_in, c_in = map(r, (xs, dt, b_in, c_in))
    xdt = xs * dt[..., None].to(xs.dtype)                  # (B,nc,Q,H,P)
    a = (dt * a_coef).float()                              # (B,nc,Q,H) <= 0
    cum = torch.cumsum(a, dim=2)                           # inclusive
    cum_t = cum.permute(0, 1, 3, 2)                        # (B,nc,H,Q)

    # within-chunk (diag) term.  Masked before the exp: above the diagonal
    # diff > 0 overflows to inf at real step sizes, and the reference's
    # where(mask, exp(diff), 0) then carries 0 * inf = nan into diff's
    # gradient; the values are the same
    diff = cum_t[..., :, None] - cum_t[..., None, :]       # (B,nc,H,Q,Q)
    mask = torch.ones((q, q), dtype=torch.bool, device=xs.device).tril()
    decay = torch.exp(diff.masked_fill(~mask, float("-inf")))
    cb = torch.einsum("bcihn,bcjhn->bchij", c_in, b_in).float()
    m = (cb * decay).to(xs.dtype)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", m, xdt)

    # per-chunk input -> state and chunk decay
    last = cum_t[..., -1:]                                 # (B,nc,H,1)
    seg = torch.exp(last - cum_t)                          # (B,nc,H,Q)
    bw = b_in * seg.permute(0, 1, 3, 2)[..., None].to(b_in.dtype)
    s_c = torch.einsum("bcjhn,bcjhp->bchpn", bw, xdt)      # (B,nc,H,P,N)
    cdecay = torch.exp(last[..., 0])                       # (B,nc,H)

    # inter-chunk recurrence (carry = state entering the chunk)
    hprev = init_state
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hprev)
        hprev = hprev * cdecay[:, c, :, None, None].to(hprev.dtype) \
            + s_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # (B,nc,H,P,N)

    # cross-chunk (off-diag) term
    y_off = torch.einsum("bcihn,bchpn->bcihp", c_in,
                         h_prevs.to(c_in.dtype))
    y_off = y_off * torch.exp(cum)[..., None].to(y_off.dtype)
    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :s]
    return y, hprev


def ssm_apply(x, p, cfg, spec, *, mode, pos, cache=None, cache_len=None,
              pages=None, attn_extent=None):
    """Mamba2 block mixer. x: (B,S,D) -> (out, new_cache or None)."""
    del spec, pos, cache_len, pages, attn_extent
    if mode == "prefill_chunk":
        raise NotImplementedError(
            "chunked prefill is not supported for SSM blocks")
    b, s, _ = x.shape
    k_tp = tp_ssm_heads(cfg.ssm_nheads)                   # 1 off a mesh
    h, pd, n, g = (cfg.ssm_nheads // k_tp, cfg.ssm_headdim, cfg.ssm_state,
                   cfg.ssm_ngroups)
    di, cw = cfg.d_inner // k_tp, cfg.ssm_conv
    h0 = tp_coord("ssm_heads") * h          # this rank's first head
    dt_ = x.dtype
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    w_xbc, conv_w, conv_b = (p[k].to(dt_) for k in ("wxBC", "conv_w",
                                                    "conv_b"))
    if k_tp > 1:
        xn = tp_enter(xn)
        if torch.is_grad_enabled():
            w_xbc, conv_w, conv_b = (_with_bc_shared(t, di) for t in (
                w_xbc, conv_w, conv_b))

    z = xn @ p["wz"].to(dt_)
    xbc = xn @ w_xbc
    dt = F.softplus((xn @ p["wdt"].to(dt_)).float()
                    + p["dt_bias"].float())
    a_coef = -torch.exp(p["A_log"].float())                # (H,)

    new_cache = None
    if mode == "decode":
        conv_c = cache["conv"]
        win = torch.cat([conv_c.to(dt_), xbc], dim=1)       # (B,W,C)
        conv = F.silu(torch.einsum("bwc,wc->bc", win, conv_w)
                      + conv_b)[:, None, :]                 # (B,1,C)
        conv_c.copy_(win[:, 1:])                            # in place
    elif mode in ("train", "prefill"):
        conv = _causal_conv(xbc, conv_w, conv_b)
        new_conv = xbc[:, -(cw - 1):] if s >= cw - 1 else None
    else:
        raise ValueError(f"unknown mode {mode!r}")

    xs = conv[..., :di].reshape(b, s, h, pd)
    bc = conv[..., di:].reshape(b, s, 2, g, n)
    # every head's group (all of them: B and C are whole on every rank),
    # then this rank's heads; one group stays a stride-0 view
    hh, rep = cfg.ssm_nheads, cfg.ssm_nheads // g
    b_in = bc[:, :, 0, :, None].expand(b, s, g, rep, n).reshape(
        b, s, hh, n)[:, :, h0:h0 + h]
    c_in = bc[:, :, 1, :, None].expand(b, s, g, rep, n).reshape(
        b, s, hh, n)[:, :, h0:h0 + h]

    if mode == "decode":
        hst = cache["state"]                               # (B,H,P,N)
        da = torch.exp(dt[:, 0] * a_coef)                  # (B,H)
        upd = torch.einsum("bhn,bhp->bhpn", b_in[:, 0],
                           xs[:, 0] * dt[:, 0, :, None].to(dt_))
        hst.copy_(hst * da[:, :, None, None].to(hst.dtype) + upd)
        y = torch.einsum("bhn,bhpn->bhp", c_in[:, 0], hst.to(dt_))[:, None]
        new_cache = {"conv": conv_c, "state": hst}
    else:
        y, h_final = ssd_scan(xs, dt, a_coef, b_in, c_in,
                              chunk=cfg.ssm_chunk)
        if mode == "prefill":
            new_cache = {"conv": new_conv, "state": h_final.to(dt_)}

    y = y + xs * p["Dskip"].to(dt_)[:, None]
    y = y.reshape(b, s, di)
    y = gated_rms_norm(y, z, p["norm_w"], cfg.norm_eps, width=cfg.d_inner)
    out = y @ p["out_proj"].to(dt_)
    return (tp_all_reduce(out) if k_tp > 1 else out), new_cache
