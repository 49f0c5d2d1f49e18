"""int8 gradient compression with error feedback (PyTorch port of
``repro/optim/compress.py``).

Each gradient leaf is quantised to int8 with a per-leaf f32 scale
(``amax / 127``); the residual is carried in an error-feedback buffer and
added back the next step, so the compressed direction is unbiased over
time.  On a cluster the int8 payload is what would cross the
interconnect; here the transform is exercised numerically.
"""
from __future__ import annotations

import torch

from ..models.layers import tree_map


def ef_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _scale(g):
    return (g.abs().max() + 1e-12) / 127.0


def _quant(g, scale):
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def compress_grads(grads, ef):
    """Returns (quantised_tree, scales_tree, new_ef)."""
    corrected = tree_map(lambda g, e: g.float() + e, grads, ef)
    scales = tree_map(_scale, corrected)
    q = tree_map(_quant, corrected, scales)
    new_ef = tree_map(lambda c, qq, s: c - qq.float() * s, corrected, q,
                      scales)
    return q, scales, new_ef


def decompress_grads(q, scales):
    return tree_map(lambda qq, s: qq.float() * s, q, scales)
