"""Decoder LM over a repeating block pattern (PyTorch port of
``repro/models/lm.py``).

Parameters and caches are plain dict/tuple trees in the reference's
layout: per-pattern-position leaves stacked on a leading ``n_repeats``
axis, flat ``(d, H*dh)`` projection weights.  A Python loop over the
repeats takes the place of ``lax.scan``; there is no remat (the port
serves, it does not train yet).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .blocks import block_apply, block_cache_shapes, block_param_shapes
from .layers import embed_tokens, lm_logits, rms_norm, tree_map


class LeafMeta(NamedTuple):
    shape: tuple
    init: str = "normal"


def _is_meta(x):
    return isinstance(x, LeafMeta)


def _stack_meta(tree, repeats):
    """{name: (shape, init)} trees -> LeafMeta trees stacked on repeats."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _stack_meta(v, repeats)
        else:
            shape, init = v
            out[k] = LeafMeta((repeats,) + tuple(shape), init)
    return out


# ------------------------------------------------------------------- meta
def param_meta(cfg):
    d, v = cfg.d_model, cfg.vocab
    if cfg.frontend == "audio_codebooks":
        raise NotImplementedError(
            f"{cfg.name}: the audio frontend is not ported yet "
            "(ROADMAP.md queue 1, item 7)")
    out = {
        "embed": {"tok": LeafMeta((v, d))},
        "blocks": tuple(_stack_meta(block_param_shapes(cfg, spec),
                                    cfg.n_repeats)
                        for spec in cfg.pattern),
        "final_norm": LeafMeta((d,), "ones"),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = LeafMeta((d, v))
    return out


def cache_meta(cfg, batch: int, seq: int):
    blocks = tuple(
        {name: LeafMeta((cfg.n_repeats,) + tuple(shape), "zeros")
         for name, shape in block_cache_shapes(cfg, spec, batch,
                                               seq).items()}
        for spec in cfg.pattern)
    return {"pos": LeafMeta((), "zeros"), "blocks": blocks}


# ------------------------------------------------------------------- init
def _init_leaf(m: LeafMeta, cfg, generator, device, dtype):
    if m.init == "zeros":
        return torch.zeros(m.shape, dtype=dtype, device=device)
    if m.init == "ones":
        return torch.ones(m.shape, dtype=dtype, device=device)
    if m.init in ("A_log", "dt_bias"):
        h = m.shape[-1]
        if m.init == "A_log":
            base = np.log(np.linspace(1.0, 16.0, h, dtype=np.float32))
        else:
            dt0 = np.linspace(1e-3, 1e-1, h, dtype=np.float32)
            base = np.log(np.expm1(dt0))
        return torch.from_numpy(np.array(np.broadcast_to(base, m.shape))
                                ).to(device=device, dtype=dtype)
    std = 0.02 / np.sqrt(2.0 * cfg.n_layers) if m.init == "normal_out" \
        else 0.02
    out = torch.empty(m.shape, dtype=dtype, device=device)
    # one f32 slice at a time: a stacked 14B leaf never exists in f32
    for part in (out.view(-1, *m.shape[-2:]) if out.dim() > 2 else [out]):
        part.copy_(torch.randn(part.shape, generator=generator,
                               device=device, dtype=torch.float32).mul_(std))
    return out


def init_params(cfg, generator: torch.Generator, device="cuda",
                dtype=None):
    """Seeded weights in the reference's layout and init kinds (normal
    0.02, ``normal_out``, zeros for the QKV biases, ones for the norms,
    the SSM's fixed ``A_log`` and ``dt_bias`` ramps),
    made directly on ``device`` one leaf at a time.  ``dtype`` defaults
    to ``cfg.dtype``.  ``torch.Generator`` and ``jax.random`` give
    different numbers from one seed: tests that compare with the
    reference hand its weights over through ``repro_torch.params``."""
    device = resolve_device(device)
    dtype = getattr(torch, dtype or cfg.dtype)
    return tree_map(lambda m: _init_leaf(m, cfg, generator, device, dtype),
                    param_meta(cfg), is_leaf=_is_meta)


def init_cache(cfg, batch: int, seq: int, dtype, device="cuda"):
    device = resolve_device(device)
    return tree_map(
        lambda m: torch.zeros(m.shape, device=device,
                              dtype=torch.int32 if m.shape == () else dtype),
        cache_meta(cfg, batch, seq), is_leaf=_is_meta)


def _layer(tree, r):
    return tree_map(lambda t: t[r], tree)


# ---------------------------------------------------------------- forward
@torch.no_grad()
def forward(params, cfg, tokens, *, mode="train", pos=0, cache=None,
            cache_len=None, pages=None, attn_extent=None, want_logits=True):
    """tokens: (B, S) int.  Returns {"logits", "cache"} (the reference's
    MoE "aux" term belongs to the training slice).

    mode: "train" (all-position logits, no cache) | "prefill" (cache
    padded to ``cache_len`` + last-position logits) | "decode" (S == 1;
    ``pos`` a scalar or (B,) per-slot positions; the cache is updated in
    place and its ``pos`` advanced by one) | "prefill_chunk" (a
    cache-append chunk: the S tokens are written in place at ``[pos, pos
    + S)`` of a dense row cache, ``pos`` a host int; last-position
    logits, like "prefill").  ``pages`` (decode): the paged-KV descriptor
    ``{"table", "page_size", "cache_len", "kernel"}`` of
    ``repro.models.lm.forward``.  ``attn_extent`` (prefill_chunk): the
    chunk attends over the first ``attn_extent`` cache positions (must
    cover pos + S); ``want_logits=False`` (prefill_chunk) skips the final
    norm and the LM head of a non-final chunk.  The reference's "verify"
    mode belongs to a later slice."""
    if mode not in ("train", "prefill", "decode", "prefill_chunk"):
        raise NotImplementedError(
            f"forward mode {mode!r} is not ported yet (ROADMAP.md queue 1, "
            "item 5)")
    if cfg.pos_emb != "rope":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.pos_emb!r} positions are not ported yet "
            "(ROADMAP.md queue 1, item 7)")
    dt = getattr(torch, cfg.dtype)
    x = embed_tokens(tokens, params["embed"], cfg, dt)
    s = x.shape[1]
    cache_in = mode in ("decode", "prefill_chunk")
    if cache_in:
        cache_blocks = cache["blocks"]
        new_blocks = cache_blocks                   # updated in place
    else:
        new_blocks = [None] * len(cfg.pattern)

    for r in range(cfg.n_repeats):
        for i, spec in enumerate(cfg.pattern):
            bc = _layer(cache_blocks[i], r) if cache_in else None
            x, nc = block_apply(x, _layer(params["blocks"][i], r), cfg, spec,
                                mode=mode, pos=pos, cache=bc,
                                cache_len=cache_len, pages=pages,
                                attn_extent=attn_extent)
            if mode == "prefill":
                if new_blocks[i] is None:
                    new_blocks[i] = {
                        k: v.new_empty((cfg.n_repeats,) + tuple(v.shape))
                        for k, v in nc.items()}
                for k, v in nc.items():
                    new_blocks[i][k][r] = v

    new_cache = None
    if mode == "decode":
        new_cache = {"pos": cache["pos"] + 1, "blocks": new_blocks}
    elif mode == "prefill_chunk":
        new_cache = {"pos": torch.full((), pos + s, dtype=torch.int32,
                                       device=x.device),
                     "blocks": new_blocks}
        x = x[:, -1:]
    elif mode == "prefill":
        new_cache = {"pos": torch.full((), s, dtype=torch.int32,
                                       device=x.device),
                     "blocks": tuple(new_blocks)}
        x = x[:, -1:]
    if not want_logits:                 # non-final chunk: cache only
        return {"logits": None, "cache": new_cache}
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return {"logits": lm_logits(x, params, cfg), "cache": new_cache}
