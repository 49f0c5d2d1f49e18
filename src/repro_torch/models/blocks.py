"""Residual block = mixer (GQA or MLA attention, or SSD) + MLP (dense,
top-k MoE, or none) (PyTorch port of ``repro/models/blocks.py``).
``cfg.moe_impl`` picks the MoE dispatch: "onehot" (capacity, the
reference's default) or "ragged" (dropless)."""
from __future__ import annotations

from . import attention as attn_mod
from .layers import check_cache_invariant, mlp_dense, rms_norm
from .moe import moe_mlp, moe_mlp_ragged, moe_param_shapes
from .ssm import ssm_apply, ssm_cache_shapes, ssm_param_shapes


def _mixer(spec):
    if spec.kind == "ssm":
        return ssm_param_shapes, ssm_cache_shapes, ssm_apply
    if spec.attn == "mla":
        return attn_mod.mla_param_shapes, attn_mod.mla_cache_shapes, \
            attn_mod.mla_apply
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
        out["mlp"] = moe_param_shapes(cfg)
    return out


def block_cache_shapes(cfg, spec, batch, seq):
    _, cache_fn, _ = _mixer(spec)
    return cache_fn(cfg, spec, batch, seq)


def block_apply(x, p, cfg, spec, *, mode, pos, cache=None, cache_len=None,
                pages=None, attn_extent=None):
    """Returns the new residual stream and the block's new cache.  The
    MoE load-balance term is dropped: it only matters to training."""
    _, _, apply_fn = _mixer(spec)
    out, new_cache = apply_fn(x, p["mixer"], cfg, spec, mode=mode, pos=pos,
                              cache=cache, cache_len=cache_len, pages=pages,
                              attn_extent=attn_extent)
    if mode in ("decode", "prefill_chunk"):
        check_cache_invariant(cache, new_cache, f"{spec.kind}/{spec.attn}")
    x = x + out
    if spec.mlp != "none":
        xn = rms_norm(x, p["mlp"]["ln"], cfg.norm_eps)
        if spec.mlp == "dense":
            y = mlp_dense(xn, p["mlp"], cfg)
        else:
            fn = moe_mlp_ragged if cfg.moe_impl == "ragged" else moe_mlp
            y, _ = fn(xn, p["mlp"], cfg, aux=False)
        x = x + y
    return x, new_cache
