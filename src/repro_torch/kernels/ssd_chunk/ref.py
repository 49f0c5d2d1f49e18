"""Plain PyTorch version of the SSD chunk scan: the port's
``models.ssm.ssd_chunked`` with a zero f32 initial state, as
``repro/kernels/ssd_chunk/ref.py`` runs the reference's.  The CPU path of
:func:`.ops.ssd_scan` and the kernel's oracle on the card."""
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
