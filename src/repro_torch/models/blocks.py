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
        "ln": ((d,), (None,), "ones"),
        "w_gate": ((d, f), ("fsdp", "tp"), "normal"),
        "w_up": ((d, f), ("fsdp", "tp"), "normal"),
        "w_down": ((f, d), ("tp", "fsdp"), "normal"),
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
                pages=None, attn_extent=None, n_tok=None, data=None):
    """Returns ``(x, new_cache, aux)``: the new residual stream, the
    block's new cache and its MoE load-balance term — a 0-d f32 tensor
    from a MoE block in train mode, else 0.0 (the serve modes never ask
    for it), its means over the global batch on the train mesh ``data``
    (``moe.global_stats``).  ``n_tok`` (verify mode) is passed to the
    mixer only when set, so the SSD mixer, which never verifies
    (``steps.speculatable``), keeps its signature."""
    _, _, apply_fn = _mixer(spec)
    kw = {} if n_tok is None else {"n_tok": n_tok}
    out, new_cache = apply_fn(x, p["mixer"], cfg, spec, mode=mode, pos=pos,
                              cache=cache, cache_len=cache_len, pages=pages,
                              attn_extent=attn_extent, **kw)
    if mode in ("decode", "prefill_chunk", "verify"):
        check_cache_invariant(cache, new_cache, f"{spec.kind}/{spec.attn}")
    x = x + out
    aux = 0.0
    if spec.mlp != "none":
        xn = rms_norm(x, p["mlp"]["ln"], cfg.norm_eps)
        if spec.mlp == "dense":
            y = mlp_dense(xn, p["mlp"], cfg)
        else:
            fn = moe_mlp_ragged if cfg.moe_impl == "ragged" else moe_mlp
            y, lb = fn(xn, p["mlp"], cfg, aux=mode == "train", data=data)
            aux = 0.0 if lb is None else lb
        x = x + y
    return x, new_cache, aux
