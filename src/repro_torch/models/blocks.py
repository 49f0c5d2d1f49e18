"""Residual block = attention mixer + dense MLP (PyTorch port of
``repro/models/blocks.py``).  SSM mixers, MLA and MoE belong to later
slices and raise."""
from __future__ import annotations

from . import attention as attn_mod
from .layers import check_cache_invariant, mlp_dense, rms_norm


def _unported(what, item):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, item {item})")


def _mixer(spec):
    if spec.kind == "ssm":
        _unported("the SSM mixer", 8)
    if spec.attn == "mla":
        _unported("MLA attention", 6)
    return attn_mod.gqa_param_shapes, attn_mod.gqa_cache_shapes, \
        attn_mod.gqa_apply


def dense_mlp_shapes(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln": ((d,), "ones"),
        "w_gate": ((d, f), "normal"),
        "w_up": ((d, f), "normal"),
        "w_down": ((f, d), "normal"),
    }


def block_param_shapes(cfg, spec):
    shapes_fn, _, _ = _mixer(spec)
    out = {"mixer": shapes_fn(cfg)}
    if spec.mlp == "dense":
        out["mlp"] = dense_mlp_shapes(cfg)
    elif spec.mlp == "moe":
        _unported("the MoE MLP", 7)
    return out


def block_cache_shapes(cfg, spec, batch, seq):
    _, cache_fn, _ = _mixer(spec)
    return cache_fn(cfg, spec, batch, seq)


def block_apply(x, p, cfg, spec, *, mode, pos, cache=None, cache_len=None,
                pages=None):
    """Returns the new residual stream and the block's new cache."""
    _, _, apply_fn = _mixer(spec)
    out, new_cache = apply_fn(x, p["mixer"], cfg, spec, mode=mode, pos=pos,
                              cache=cache, cache_len=cache_len, pages=pages)
    if mode == "decode":
        check_cache_invariant(cache, new_cache, f"{spec.kind}/{spec.attn}")
    x = x + out
    if spec.mlp == "dense":
        xn = rms_norm(x, p["mlp"]["ln"], cfg.norm_eps)
        x = x + mlp_dense(xn, p["mlp"], cfg)
    elif spec.mlp != "none":
        _unported("the MoE MLP", 7)
    return x, new_cache
