"""Decoder LM over a repeating block pattern (PyTorch port of
``repro/models/lm.py``).

Parameters and caches are plain dict/tuple trees in the reference's
layout: per-pattern-position leaves stacked on a leading ``n_repeats``
axis, flat ``(d, H*dh)`` projection weights.  A Python loop over the
repeats takes the place of ``lax.scan``.  In train mode under autograd,
``cfg.remat`` checkpoints each repeat of the pattern
(``torch.utils.checkpoint``, non-reentrant): ``"full"`` saves nothing
inside it, the reference's ``jax.checkpoint`` of its scan body under
``nothing_saveable``; ``"dots"`` saves the outputs of the matrix products
(``mm``, ``addmm``, ``bmm``, ``baddbmm``) and recomputes everything else,
its ``checkpoint_dots``.  The CUDA kernels launch through ``ctypes``
below the policy's sight, so under ``"dots"`` they are recomputed.  The
serve modes run under ``torch.no_grad()``.

Sharded training: on a mesh, train mode takes ``fsdp=`` (the step's
``sharding.fsdp.Plan``): each split leaf is gathered over ``data`` where
it is used (the embedding, each repeat's block inside its remat
checkpoint, the final norm, the head), into this model rank's
tensor-parallel block, and a MoE layer's load-balance term takes its
means over the plan's data axis (``models.moe.global_stats``).  The
model axis's collectives come from the active ``sharding_ctx``; a
checkpointed repeat reopens the context it was recorded under, since
its recompute may run on autograd's device thread, so under remat
"full" the backward runs each repeat's forward collectives once more.
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..sharding import current_mesh, current_rules, sharding_ctx
from ..sharding.fsdp import take
from .blocks import block_apply, block_cache_shapes, block_param_shapes
from .layers import (embed_tokens, lm_logits, rms_norm, sinusoidal_pos,
                     tree_leaves, tree_map)


class LeafMeta(NamedTuple):
    """A leaf of the meta tree: its shape, its logical axes (one name or
    None per dim, the reference's ``repro.sharding`` vocabulary) and its
    init kind."""
    shape: tuple
    axes: tuple
    init: str = "normal"


def _is_meta(x):
    return isinstance(x, LeafMeta)


def _stack_meta(tree, repeats, init=None):
    """{name: (shape, axes[, init])} trees -> LeafMeta trees stacked on
    ``repeats`` (the leading "stack" axis); ``init`` overrides the kind."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _stack_meta(v, repeats, init)
        else:
            shape, axes, kind = (tuple(v) + ("normal",))[:3]
            out[k] = LeafMeta((repeats,) + tuple(shape), ("stack",)
                              + tuple(axes), init or kind)
    return out


# ------------------------------------------------------------------- meta
def param_meta(cfg):
    d, v = cfg.d_model, cfg.vocab
    if cfg.frontend == "audio_codebooks":       # one table and head per
        k = cfg.n_codebooks                     # codebook
        embed = LeafMeta((k, v, d), (None, "vocab", "fsdp"))
        head = LeafMeta((k, d, v), (None, "fsdp", "vocab"))
    else:
        embed = LeafMeta((v, d), ("vocab", "fsdp"))
        head = LeafMeta((d, v), ("fsdp", "vocab"))
    out = {
        "embed": {"tok": embed},
        "blocks": tuple(_stack_meta(block_param_shapes(cfg, spec),
                                    cfg.n_repeats)
                        for spec in cfg.pattern),
        "final_norm": LeafMeta((d,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = head
    return out


def cache_meta(cfg, batch: int, seq: int):
    blocks = tuple(_stack_meta(block_cache_shapes(cfg, spec, batch, seq),
                               cfg.n_repeats, "zeros")
                   for spec in cfg.pattern)
    return {"pos": LeafMeta((), (), "zeros"), "blocks": blocks}


def meta_axes(meta):
    """The logical axes of every leaf of a meta tree (the reference's
    ``meta_axes``)."""
    return tree_map(lambda m: m.axes, meta, is_leaf=_is_meta)


def param_logical_axes(cfg):
    return meta_axes(param_meta(cfg))


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


def _gathered(fsdp, params, *path, r=None):
    """The subtree of ``params`` at ``path`` (repeat ``r`` of a stacked
    block) whole on this rank: under FSDP (``fsdp``, a
    ``sharding.fsdp.Plan``) each split leaf is gathered here, where it is
    used, so a repeat's gathers run inside its ``checkpoint`` and its
    backward's recompute gathers again."""
    tree, dims = params, None if fsdp is None else fsdp.dims
    for k in path:
        tree, dims = tree[k], None if dims is None else dims[k]
    if fsdp is None:
        return tree if r is None else _layer(tree, r)
    return take(tree, dims, fsdp.mesh, r)


# ---------------------------------------------------------------- forward
def forward(params, cfg, tokens, *, mode="train", pos=0, cache=None,
            patches=None, cache_len=None, pages=None, attn_extent=None,
            want_logits=True, n_tok=None, fsdp=None):
    """tokens: (B, S) int, or (B, S, K) codebook ids for the audio
    frontend, whose logits are then (B, S, K, V).  ``patches`` (vision):
    (B, n_patches, d_model) embeddings put in front of the text, always
    in "train" and "prefill", on the first chunk only in "prefill_chunk"
    (later chunks continue at ``pos`` past them); "train" drops their
    positions before the final norm.  Sinusoidal positions (audio) are
    added to the embedding in every mode.

    Returns {"logits", "cache", "aux"}: ``aux``
    is the MoE load-balance term summed over the layers (a 0-d f32
    tensor) in train mode, None in the serve modes, whose callers never
    read it.  Train mode records autograd when the caller's grad mode is
    on; the serve modes run under ``torch.no_grad()``.

    mode: "train" (all-position logits, no cache) | "prefill" (cache
    padded to ``cache_len`` + last-position logits) | "decode" (S == 1;
    ``pos`` a scalar or (B,) per-slot positions; the cache is updated in
    place and its ``pos`` advanced by one) | "prefill_chunk" (a
    cache-append chunk: the S tokens are written in place at ``[pos, pos
    + S)`` of a dense row cache, ``pos`` a host int; last-position
    logits, like "prefill") | "verify" (speculative decoding: a window of
    S tokens per slot written in place at per-slot positions ``pos`` (B,)
    onward, lanes ``>= n_tok`` (B,) masked; logits for all S lanes, and
    the cache's ``pos`` comes back unchanged: the engine owns
    acceptance, so positions are host-authoritative there).  ``pages``
    (decode, verify): the paged-KV descriptor ``{"table", "page_size",
    "cache_len", "kernel"}`` of ``repro.models.lm.forward``.
    ``attn_extent`` (prefill_chunk): the chunk attends over the first
    ``attn_extent`` cache positions (must cover pos + S);
    ``want_logits=False`` (prefill_chunk) skips the final norm and the LM
    head of a non-final chunk.  ``fsdp`` (train mode on a mesh: a
    ``sharding.fsdp.Plan``): ``params`` are this rank's blocks, each split
    leaf gathered where it is used (the embedding, each repeat's weights,
    the final norm, the head), over ``data`` only; the MoE load-balance
    term's means span the global batch (``models.moe.global_stats``)."""
    if mode not in ("train", "prefill", "decode", "prefill_chunk",
                    "verify"):
        raise ValueError(f"unknown forward mode {mode!r}")
    with contextlib.nullcontext() if mode == "train" else torch.no_grad():
        return _forward(params, cfg, tokens, mode=mode, pos=pos, cache=cache,
                        patches=patches, cache_len=cache_len, pages=pages,
                        attn_extent=attn_extent, want_logits=want_logits,
                        n_tok=n_tok, fsdp=fsdp)


_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
         torch.ops.aten.baddbmm)


def _save_dots(ctx, func, *args, **kwargs):
    """``checkpoint_dots``: keep the products' outputs, recompute the
    rest."""
    return (CheckpointPolicy.MUST_SAVE if func.overloadpacket in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(params, cfg):
    """The ``checkpoint`` keywords of each repeat in train mode, or None
    when it is not checkpointed: autograd records nothing (grad mode off,
    no weight requiring grad) or ``cfg.remat`` is ``"none"``."""
    if cfg.remat == "none" or not torch.is_grad_enabled() or not any(
            t.requires_grad for t in tree_leaves(params)):
        return None
    if cfg.remat == "full":
        return {"use_reentrant": False}
    if cfg.remat == "dots":
        return {"use_reentrant": False, "context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    raise ValueError(f"{cfg.name}: remat={cfg.remat!r}; pick 'none', "
                     "'dots' or 'full'")


def _positions(mode, pos, s, device):
    """The positions of the S rows of x, shaped to broadcast against (B,
    S): decode's per-slot (B,) positions as (B, 1), verify's windows (B,
    S), the other modes' ``pos + arange(S)``."""
    if mode == "decode":
        pos = torch.as_tensor(pos, device=device)
        return pos[:, None] if pos.dim() == 1 else pos.reshape(1)
    if mode == "verify":
        return torch.as_tensor(pos, device=device)[:, None] + torch.arange(
            s, device=device)
    return pos + torch.arange(s, device=device)


def _forward(params, cfg, tokens, *, mode, pos, cache, patches, cache_len,
             pages, attn_extent, want_logits, n_tok, fsdp):
    if mode == "verify" and n_tok is None:
        raise ValueError("verify mode needs n_tok")
    if fsdp is not None and mode != "train":
        raise ValueError(f"mode {mode!r}: FSDP gathers train mode only")
    dt = getattr(torch, cfg.dtype)
    x = embed_tokens(tokens, _gathered(fsdp, params, "embed"), cfg, dt)
    vision = cfg.frontend == "vision_patches"
    if vision and mode in ("train", "prefill"):
        if patches is None:
            raise ValueError(f"{cfg.name}: mode {mode!r} needs the "
                             f"{cfg.n_patches} patch embeddings (patches=)")
    elif mode != "prefill_chunk":
        patches = None
    if patches is not None:
        x = torch.cat([torch.as_tensor(patches, device=x.device).to(dt), x],
                      dim=1)
    s = x.shape[1]
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_pos(_positions(mode, pos, s, x.device),
                               cfg.d_model).to(dt)
    train = mode == "train"
    cache_in = mode in ("decode", "prefill_chunk", "verify")
    if cache_in:
        cache_blocks = cache["blocks"]
        new_blocks = cache_blocks                   # updated in place
    else:
        new_blocks = [None] * len(cfg.pattern)

    def repeat(x, aux, r):
        """One repeat of the pattern: the scan body of the reference."""
        ncs = []
        for i, spec in enumerate(cfg.pattern):
            bc = _layer(cache_blocks[i], r) if cache_in else None
            w = _gathered(fsdp, params, "blocks", i, r=r)
            x, nc, a = block_apply(x, w, cfg, spec, mode=mode, pos=pos,
                                   cache=bc, cache_len=cache_len,
                                   pages=pages, attn_extent=attn_extent,
                                   n_tok=n_tok,
                                   data=None if fsdp is None else fsdp.mesh)
            ncs.append(nc)
            if not isinstance(a, float):
                aux = aux + a
        return x, aux, ncs

    mesh, rules = current_mesh(), current_rules()

    def train_repeat(x, aux, r):
        # the recompute may run on another thread: reopen the context
        with (contextlib.nullcontext() if mesh is None
              else sharding_ctx(mesh, rules)):
            return repeat(x, aux, r)[:2]

    aux = torch.zeros((), dtype=torch.float32, device=x.device) \
        if train else None
    remat = _remat(params, cfg) if train else None
    for r in range(cfg.n_repeats):
        if remat is not None:
            # ``r`` bound now: the backward recomputes after the loop ends
            x, aux = checkpoint(functools.partial(train_repeat, r=r), x, aux,
                                **remat)
            continue
        x, aux, ncs = repeat(x, aux, r)
        if mode == "prefill":
            for i, nc in enumerate(ncs):
                if new_blocks[i] is None:
                    new_blocks[i] = {
                        k: v.new_empty((cfg.n_repeats,) + tuple(v.shape))
                        for k, v in nc.items()}
                for k, v in nc.items():
                    new_blocks[i][k][r] = v

    new_cache = None
    if train and vision:
        x = x[:, cfg.n_patches:]
    if mode == "decode":
        new_cache = {"pos": cache["pos"] + 1, "blocks": new_blocks}
    elif mode == "verify":
        new_cache = {"pos": cache["pos"], "blocks": new_blocks}
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
        return {"logits": None, "cache": new_cache, "aux": aux}
    x = rms_norm(x, _gathered(fsdp, params, "final_norm"), cfg.norm_eps)
    head = "lm_head" if "lm_head" in params else "embed"
    return {"logits": lm_logits(x, {head: _gathered(fsdp, params, head)},
                                cfg),
            "cache": new_cache, "aux": aux}
