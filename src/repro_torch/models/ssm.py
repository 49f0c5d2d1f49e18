"""Mamba2 (SSD, state-space duality) mixer (PyTorch port of
``repro/models/ssm.py``).

Train and prefill run the chunked SSD form; decode is the O(1) recurrent
update.  The scan goes through the SSD kernel's wrapper
(``repro_torch.kernels.ssd_scan``: the hand-written CUDA kernel on the
card, its plain version ``ssd_chunked`` on the CPU).  The reference model
calls ``ssd_chunked`` itself, with the state carried in the activation
dtype; the kernel carries it in f32 and its ``h_final`` is cast to the
activation dtype — the same numbers in f32, within bf16 rounding in bf16.

The SSM cache (conv tail + recurrent state) is O(1) per slot and never
paged.  Decode writes both leaves in place (the port's forward keeps the
same cache tensors); chunked prefill raises, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ssd_scan
from .layers import gated_rms_norm, rms_norm


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def ssm_param_shapes(cfg):
    """name -> (shape, init kind), the reference's layout."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    cd = conv_dim(cfg)
    return {
        "ln": ((d,), "ones"),
        "wz": ((d, di), "normal"),
        "wxBC": ((d, cd), "normal"),
        "wdt": ((d, h), "normal"),
        "dt_bias": ((h,), "dt_bias"),
        "A_log": ((h,), "A_log"),
        "Dskip": ((h,), "ones"),
        "conv_w": ((cfg.ssm_conv, cd), "normal"),
        "conv_b": ((cd,), "zeros"),
        "norm_w": ((di,), "ones"),
        "out_proj": ((di, d), "normal"),
    }


def ssm_cache_shapes(cfg, spec, batch, seq):
    del spec, seq
    h, p, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    return {"conv": (batch, cfg.ssm_conv - 1, conv_dim(cfg)),
            "state": (batch, h, p, n)}


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
    (B,H,P,N) in the dtype the carry promotes to from ``init_state``)."""
    b, s, h, p = xs.shape
    nc = max(1, s // chunk)
    q = s // nc
    if nc * q != s:
        raise ValueError(f"ssd_chunked: {s} positions do not split into "
                         f"{nc} equal chunks")

    def r(t):
        return t.reshape(b, nc, q, *t.shape[2:])

    xs, dt, b_in, c_in = map(r, (xs, dt, b_in, c_in))
    xdt = xs * dt[..., None].to(xs.dtype)                  # (B,nc,Q,H,P)
    a = (dt * a_coef).float()                              # (B,nc,Q,H) <= 0
    cum = torch.cumsum(a, dim=2)                           # inclusive
    cum_t = cum.permute(0, 1, 3, 2)                        # (B,nc,H,Q)

    # within-chunk (diag) term
    diff = cum_t[..., :, None] - cum_t[..., None, :]       # (B,nc,H,Q,Q)
    mask = torch.ones((q, q), dtype=torch.bool, device=xs.device).tril()
    decay = torch.where(mask, torch.exp(diff), 0.0)
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
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, hprev


def ssm_apply(x, p, cfg, spec, *, mode, pos, cache=None, cache_len=None,
              pages=None):
    """Mamba2 block mixer. x: (B,S,D) -> (out, new_cache or None)."""
    del spec, pos, cache_len, pages
    if mode == "prefill_chunk":
        raise NotImplementedError(
            "chunked prefill is not supported for SSM blocks")
    b, s, _ = x.shape
    h, pd, n, g = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                   cfg.ssm_ngroups)
    di, cw = cfg.d_inner, cfg.ssm_conv
    dt_ = x.dtype
    xn = rms_norm(x, p["ln"], cfg.norm_eps)

    z = xn @ p["wz"].to(dt_)
    xbc = xn @ p["wxBC"].to(dt_)
    dt = F.softplus((xn @ p["wdt"].to(dt_)).float()
                    + p["dt_bias"].float())
    a_coef = -torch.exp(p["A_log"].float())                # (H,)

    new_cache = None
    if mode == "decode":
        conv_c = cache["conv"]
        win = torch.cat([conv_c.to(dt_), xbc], dim=1)       # (B,W,C)
        conv = F.silu(torch.einsum("bwc,wc->bc", win, p["conv_w"].to(dt_))
                      + p["conv_b"].to(dt_))[:, None, :]    # (B,1,C)
        conv_c.copy_(win[:, 1:])                            # in place
    elif mode in ("train", "prefill"):
        conv = _causal_conv(xbc, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
        new_conv = xbc[:, -(cw - 1):] if s >= cw - 1 else None
    else:
        raise ValueError(f"unknown mode {mode!r}")

    xs = conv[..., :di].reshape(b, s, h, pd)
    bc = conv[..., di:].reshape(b, s, 2, g, n)
    rep = h // g
    b_in = bc[:, :, 0, :, None].expand(b, s, g, rep, n).reshape(b, s, h, n)
    c_in = bc[:, :, 1, :, None].expand(b, s, g, rep, n).reshape(b, s, h, n)

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
    y = gated_rms_norm(y, z, p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(dt_), new_cache
