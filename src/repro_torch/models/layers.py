"""Shared layers: norms, rope, MLP, embeddings, paging (PyTorch port of
``repro/models/layers.py``).

``rms_norm`` is the kernel wrapper: the Triton kernel for CUDA tensors,
the plain version for CPU ones.  Audio and vision frontends belong to
later slices and raise.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import rms_norm

__all__ = ["rms_norm", "check_cache_invariant", "page_gather",
           "page_scatter", "rope_freqs", "apply_rope", "mlp_dense",
           "embed_tokens", "lm_logits", "tree_leaves", "tree_map"]


def _frontend_unported(cfg):
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} frontend is not ported yet "
            "(ROADMAP.md queue 1, item 7)")


# --------------------------------------------------------- cache invariance
def tree_map(fn, tree, is_leaf=None):
    """Map ``fn`` over the leaves of a dict/tuple tree."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """Leaves of a dict/tuple/list tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return tuple(_structure(t) for t in tree)
    return None


def check_cache_invariant(old, new, where: str = "block"):
    """The in-place update contract: a cache-updating mode returns every
    cache leaf with exactly its input shape and dtype (the reference's
    donation contract; here it is what lets the engine update the pool in
    place).  Raises on a breach; returns ``new``."""
    if old is None or new is None:
        return new
    if _structure(old) != _structure(new):
        raise RuntimeError(f"{where}: cache structure changed across update")
    for i, o in zip(tree_leaves(old), tree_leaves(new)):
        if i.shape != o.shape or i.dtype != o.dtype:
            raise RuntimeError(
                f"{where}: cache leaf {tuple(i.shape)}/{i.dtype} -> "
                f"{tuple(o.shape)}/{o.dtype} breaks the in-place update "
                "contract")
    return new


# ------------------------------------------------------------------- paging
def page_gather(pool, table, page_size):
    """Slot-major dense view of a paged pool: (P, page_size, ...) pages
    through the (B, pages_per_slot) block table -> (B, pps * page_size,
    ...).  The copy the paged-decode kernel avoids; kept as the gather
    leg and the oracle."""
    b, pps = table.shape
    gathered = pool[table.long()]                 # (B, pps, page_size, ...)
    return gathered.reshape((b, pps * page_size) + tuple(pool.shape[2:]))


def page_scatter(pool, table, page_size, idx, update):
    """Write one token row per slot into the paged pool, in place.

    idx: (B,) per-slot logical positions; update: (B, 1, ...).  Slots
    whose table entry is the garbage page (dead slots) all write page 0;
    which of the colliding writes lands is unspecified, which is harmless
    because page 0 is never read at a valid position."""
    idx = idx.long()
    page = torch.gather(table.long(), 1, (idx // page_size)[:, None])[:, 0]
    pool[page, idx % page_size] = update[:, 0].to(pool.dtype)
    return pool


# ----------------------------------------------------------------- positions
def rope_freqs(dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(dim: int, theta: float, device: torch.device):
    """The frequencies, copied to ``device`` once: a host-to-device copy
    per layer would make the host wait for the device at every layer."""
    return torch.from_numpy(rope_freqs(dim, theta)).to(device)


def apply_rope(x, pos, theta=10_000.0):
    """x: (..., S, H, Dh) or (..., S, Dh); pos: scalar, (S,), or (B, S)
    (per-slot decode positions) — broadcast over x.  Rotates split halves
    in f32 and casts back."""
    dh = x.shape[-1]
    freqs = _rope_freqs_on(dh, float(theta), x.device)
    pos = torch.as_tensor(pos, device=x.device)
    angles = pos.float()[..., None] * freqs               # (..., S, dh/2)
    if x.dim() == 4 and angles.dim() >= 2:                # heads dim present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- MLP
def mlp_dense(x, p, cfg):
    """SwiGLU MLP. x: (B, S, D); weights cast to x's dtype per use."""
    del cfg
    dt = x.dtype
    h = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    return (F.silu(h) * u) @ p["w_down"].to(dt)


def embed_tokens(tokens, p_embed, cfg, dtype):
    """tokens: (B, S) int -> (B, S, D)."""
    _frontend_unported(cfg)
    return p_embed["tok"].to(dtype)[tokens.long()]


def lm_logits(x, params, cfg):
    """x: (B, S, D) -> (B, S, V)."""
    _frontend_unported(cfg)
    dt = x.dtype
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].to(dt).T               # (D, V)
    else:
        w = params["lm_head"].to(dt)                      # (D, V)
    return x @ w
