"""Plain PyTorch versions of the SSD chunk scan.

``ssd_scan_ref`` is the port's ``models.ssm.ssd_chunked`` with a zero f32
initial state, as ``repro/kernels/ssd_chunk/ref.py`` runs the
reference's: the CPU path of :func:`.ops.ssd_scan` and the kernel's oracle
on the card.  The three ``*_ref`` phase functions below are the kernel's
chunk-parallel decomposition in f32 — chunk states, state pass, chunk
output — over chunks of exactly ``chunk`` positions (the last one
shorter), the oracles of the kernel's phases.
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
