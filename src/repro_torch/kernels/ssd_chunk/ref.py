"""Plain PyTorch versions of the SSD chunk scan.

``ssd_scan_ref`` is the port's ``models.ssm.ssd_chunked`` with a zero f32
initial state, as ``repro/kernels/ssd_chunk/ref.py`` runs the
reference's: the CPU path of :func:`.ops.ssd_scan` and the kernel's oracle
on the card.  The three ``*_ref`` phase functions below are the kernel's
chunk-parallel decomposition in f32 — chunk states, state pass, chunk
output — over chunks of exactly ``chunk`` positions (the last one
shorter), the oracles of the kernel's phases.

The backward: ``ssd_scan_bwd_ref`` is autograd through ``ssd_scan_ref``,
the backward kernel's oracle.  Its own decomposition, the plain version of
each launch of ``csrc/ssd_chunk_bwd.cu`` (the formulas are derived in
that file's note): the forward's chunk states and state pass again
(``h_prev``), each chunk's pull on the state entering it
(``ssd_dstates_ref``), the reverse state pass (``ssd_state_pass_bwd_ref``:
the gradient of the state leaving each chunk), C B^T once per (batch,
chunk, group) (``ssd_cb_ref``), and the within-chunk gradients from them
(``ssd_chunk_grads_ref``); ``ssd_scan_bwd_phases_ref`` chains them.
"""
from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, a, bmat, cmat, *, chunk):
    """x: (B, S, H, P); dt: (B, S, H); a: (H,); b/c: (B, S, H, N).
    Returns (y, h_final) of ``models.ssm.ssd_chunked`` with zero init."""
    from ...models.ssm import ssd_chunked     # models import the kernels

    b, _, h, p = x.shape
    init = torch.zeros((b, h, p, bmat.shape[-1]), dtype=torch.float32,
                       device=x.device)
    return ssd_chunked(x, dt.float(), a.float(), bmat, cmat, chunk, init)


def _chunks(t, chunk):
    """(B, S, ...) -> f32 (B, nc, chunk, ...), zero past S: a padded
    position has dt 0, so it adds nothing to the state or to y."""
    b, s = t.shape[:2]
    nc = -(-s // chunk)
    pad = torch.zeros((b, nc * chunk - s) + tuple(t.shape[2:]),
                      dtype=torch.float32, device=t.device)
    return torch.cat([t.float(), pad], 1).reshape(
        (b, nc, chunk) + tuple(t.shape[2:]))


def _cum(dt, a, chunk):
    """dt in chunks (B, nc, Q, H) and the inclusive cumsum of dt * a."""
    dts = _chunks(dt, chunk)
    return dts, torch.cumsum(dts * a.float(), dim=2)


def ssd_chunk_states_ref(x, dt, a, bmat, cmat, *, chunk):
    """Phase 1: each chunk's own contribution to the state, S_c = sum_j
    exp(cum_last - cum_j) dt_j x_j B_j^T, as (B, H, nc, P, N), and each
    chunk's cum_last (B, H, nc); both f32.  C is not read."""
    del cmat
    dts, cum = _cum(dt, a, chunk)
    last = cum[:, :, -1]                                   # (B, nc, H)
    w = dts * torch.exp(last[:, :, None] - cum)            # (B, nc, Q, H)
    states = torch.einsum("bcjh,bcjhp,bcjhn->bhcpn", w, _chunks(x, chunk),
                          _chunks(bmat, chunk))
    return states, last.permute(0, 2, 1).contiguous()


def ssd_state_pass_ref(states, decay):
    """Phase 2: h_c = exp(cum_last_c) h_{c-1} + S_c from h = 0.  Returns
    (h_prev (B, H, nc, P, N): the state entering each chunk, h_final
    (B, H, P, N))."""
    h = torch.zeros_like(states[:, :, 0])
    prevs = []
    for c in range(states.shape[2]):
        prevs.append(h)
        h = torch.exp(decay[:, :, c])[..., None, None] * h + states[:, :, c]
    return torch.stack(prevs, 2), h


def ssd_chunk_output_ref(x, dt, a, bmat, cmat, h_prev, *, chunk):
    """Phase 3: y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
    + exp(cum_i) C_i . h_prev^T within each chunk, in f32; returns (B, S,
    H, P) in x's dtype."""
    b, s, h, p = x.shape
    dts, cum = _cum(dt, a, chunk)
    cs = _chunks(cmat, chunk)
    cum_t = cum.permute(0, 1, 3, 2)                        # (B, nc, H, Q)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    decay = torch.where(mask, torch.exp(cum_t[..., :, None]
                                        - cum_t[..., None, :]), 0.0)
    cb = torch.einsum("bcihn,bcjhn->bchij", cs, _chunks(bmat, chunk))
    y = torch.einsum("bchij,bcjh,bcjhp->bcihp", cb * decay, dts,
                     _chunks(x, chunk))
    y = y + torch.einsum("bcihn,bhcpn->bcihp", cs, h_prev.float()) \
        * torch.exp(cum)[..., None]
    return y.reshape(b, -1, h, p)[:, :s].to(x.dtype)


# ---------------------------------------------------------------- backward
def ssd_scan_bwd_ref(x, dt, a, bmat, cmat, dy, dh_final=None, *, chunk):
    """Autograd through ``ssd_scan_ref``: (dx, ddt, da, dB, dC) for the
    output gradient ``dy`` (B, S, H, P) and, if given, ``dh_final``
    (B, H, P, N) of h_final.  dB and dC are per head (B, S, H, N), as the
    scan reads them; computed in the inputs' dtypes."""
    leaves = [t.detach().requires_grad_() for t in (x, dt, a, bmat, cmat)]
    with torch.enable_grad():
        y, hf = ssd_scan_ref(*leaves, chunk=chunk)
        outs, grads = [y], [dy.to(y.dtype)]
        if dh_final is not None:
            outs.append(hf)
            grads.append(dh_final.to(hf.dtype))
        return torch.autograd.grad(outs, leaves, grads)


def ssd_dstates_ref(dy, dt, a, cmat, *, chunk):
    """Each chunk's pull on the state entering it: E_c = sum_i exp(cum_i)
    dy_i C_i^T, as (B, H, nc, P, N) f32 (the forward's chunk states with
    dy for x, C for B and exp(cum_i) for the weight)."""
    _, cum = _cum(dt, a, chunk)
    return torch.einsum("bcih,bcihp,bcihn->bhcpn", torch.exp(cum),
                        _chunks(dy, chunk), _chunks(cmat, chunk))


def ssd_state_pass_bwd_ref(dstates, decay, dh_final=None):
    """The reverse state pass: D_c, the gradient of the state leaving
    chunk c, from D_{nc-1} = dh_final (or 0) and D_{c-1} = exp(cum_last_c)
    D_c + E_c.  Returns (D (B, H, nc, P, N), the gradient of the zero
    initial state (B, H, P, N))."""
    d = (torch.zeros_like(dstates[:, :, 0]) if dh_final is None
         else dh_final.float())
    outs = [None] * dstates.shape[2]
    for c in reversed(range(dstates.shape[2])):
        outs[c] = d
        d = torch.exp(decay[:, :, c])[..., None, None] * d + dstates[:, :, c]
    return torch.stack(outs, 2), d


def bwd_groups(bmat, cmat):
    """G, the number of distinct C B^T the backward computes a chunk: 1
    when B and C are one group's view of head stride 0 (``models/ssm.py``
    for mamba2 and jamba), else one per head."""
    return 1 if bmat.stride(2) == 0 and cmat.stride(2) == 0 \
        else bmat.shape[2]


def ssd_cb_ref(bmat, cmat, *, chunk):
    """C B^T once per (batch, chunk, group), as the backward's C B^T launch
    writes it: (B, nc, G, T, T) f32, G = ``bwd_groups`` (group g reads
    head g), T the chunk rounded up to 64; each chunk's lower triangle
    (C B^T)_ij for j <= i, zero above it and past S."""
    g = bwd_groups(bmat, cmat)
    cb = torch.einsum("bcign,bcjgn->bcgij", _chunks(cmat[:, :, :g], chunk),
                      _chunks(bmat[:, :, :g], chunk)).tril()
    pad = -(-chunk // 64) * 64 - chunk
    return torch.nn.functional.pad(cb, (0, pad, 0, pad))


def ssd_chunk_grads_ref(x, dt, a, bmat, cmat, dy, h_prev, h_final, dstate,
                        cb, *, chunk):
    """The within-chunk gradients, in f32, from the state entering each
    chunk (``h_prev`` (B, H, nc, P, N)), h_final, the gradient of the
    state leaving each chunk (``dstate``) and each chunk's C B^T once per
    group (``cb``, as ``ssd_cb_ref`` returns it).  With L_ij =
    exp(cum_i - cum_j) for j <= i in a chunk, M = (C B^T) o L,
    Z = (dY X^T) o L o dt_j and w_j = exp(cum_last - cum_j):
      dC = Z B + exp(cum_i) dY h_prev;  dB = Z^T C + w_j dt_j X D;
      W = M^T dY + w_j B D^T;  dx = dt_j W;  ddt_j = x_j . W_j + a r_j;
      dcum_i = dy_i . y_i - dt_i (x_i . W_i), plus <D, state leaving the
      chunk> at its last position; r is dcum's reverse cumsum within the
      chunk and da = sum_j dt_j r_j.
    Returns (dx, ddt, da, dB, dC): dx, dB and dC in x's dtype (dB and dC
    per head), ddt and da in f32."""
    b, s, h, p = x.shape
    dts, cum = _cum(dt, a, chunk)                      # (B, nc, Q, H)
    xs, bs, cs, dys = (_chunks(t, chunk) for t in (x, bmat, cmat, dy))
    cum_t = cum.permute(0, 1, 3, 2)                    # (B, nc, H, Q)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    ell = torch.where(mask, torch.exp(cum_t[..., :, None]
                                      - cum_t[..., None, :]), 0.0)
    g = cb[..., :chunk, :chunk].expand(-1, -1, h, -1, -1)  # (B, nc, H, Q, Q)
    m = g * ell
    z = torch.einsum("bcihp,bcjhp->bchij", dys, xs) * ell \
        * dts.permute(0, 1, 3, 2)[..., None, :]
    hp = h_prev.float().permute(0, 2, 1, 3, 4)          # (B, nc, H, P, N)
    dd = dstate.float().permute(0, 2, 1, 3, 4)
    w = torch.exp(cum[:, :, -1:] - cum)                # (B, nc, Q, H)
    # rows: dC, and dy_i . y_i as its diagonal part (sum_j M_ij dt_j
    # dy_i . x_j) and off-diagonal part (C_i . dC's off-diagonal term)
    off = torch.einsum("bcihp,bchpn->bcihn", dys, hp) \
        * torch.exp(cum)[..., None]
    dc = torch.einsum("bchij,bcjhn->bcihn", z, bs) + off
    dy_y = (g * z).sum(-1).permute(0, 1, 3, 2) + (off * cs).sum(-1)
    # columns: dB and W
    db = torch.einsum("bchij,bcihn->bcjhn", z, cs) \
        + torch.einsum("bcjhp,bchpn->bcjhn", xs, dd) * (w * dts)[..., None]
    wv = torch.einsum("bchij,bcihp->bcjhp", m, dys) \
        + torch.einsum("bcjhn,bchpn->bcjhp", bs, dd) * w[..., None]
    direct = (xs * wv).sum(-1)                         # (B, nc, Q, H)
    # the state leaving chunk c is the state entering c + 1 (h_final for
    # the last); a padded position has dt 0, so its term may sit at the
    # padded end of a short last chunk
    leaving = torch.cat([h_prev.float()[:, :, 1:],
                         h_final.float()[:, :, None]], 2)
    dcum = dy_y - dts * direct
    dcum[:, :, -1] += (dstate.float() * leaving).sum((-1, -2)).transpose(1, 2)
    r = dcum.flip(2).cumsum(2).flip(2)
    ddt = direct + a.float() * r
    da = (dts * r).sum((0, 1, 2))

    def back(t):
        return t.reshape(b, -1, *t.shape[3:])[:, :s]
    return (back(wv * dts[..., None]).to(x.dtype), back(ddt), da,
            back(db).to(x.dtype), back(dc).to(x.dtype))


def ssd_scan_bwd_phases_ref(x, dt, a, bmat, cmat, dy, dh_final=None, *,
                            chunk):
    """The backward kernel's decomposition in plain PyTorch, phase by
    phase: the same (dx, ddt, da, dB, dC) as ``ssd_scan_bwd_ref``."""
    states, decay = ssd_chunk_states_ref(x, dt, a, bmat, cmat, chunk=chunk)
    h_prev, h_final = ssd_state_pass_ref(states, decay)
    dstate, _ = ssd_state_pass_bwd_ref(
        ssd_dstates_ref(dy, dt, a, cmat, chunk=chunk), decay, dh_final)
    return ssd_chunk_grads_ref(x, dt, a, bmat, cmat, dy, h_prev, h_final,
                               dstate, ssd_cb_ref(bmat, cmat, chunk=chunk),
                               chunk=chunk)
