"""Plain PyTorch version of flash attention, the counterpart of
``repro/kernels/flash_attention/ref.py``: the CPU path of
:func:`.ops.flash_attention` and the kernel's oracle on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None,
                        chunk=512):
    """q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D).  Returns (B, Sq, H, D) in
    q's dtype.  f32 scores; causal is top-left aligned (key j <= query i,
    both from 0); the window keeps j > i - window; GQA by repeating each
    kv head over its group; a row with no valid key gives zeros.  Queries
    go ``chunk`` rows at a time, so the f32 scores take (B, H, chunk, Sk)
    at most."""
    sq, h, d = q.shape[1:]
    sk, hkv = k.shape[1], k.shape[2]
    scale = (d ** -0.5) if scale is None else scale
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(sk, device=q.device)[None, :]
    outs = []
    for q0 in range(0, sq, chunk):
        qc = q[:, q0:q0 + chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kf) * scale
        qpos = torch.arange(q0, q0 + qc.shape[1], device=q.device)[:, None]
        mask = torch.ones((qc.shape[1], sk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        p = p * mask.any(dim=-1)[:, None].float()   # no valid key -> zeros
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype))
    return torch.cat(outs, dim=1) if outs else q.new_empty(q.shape)
