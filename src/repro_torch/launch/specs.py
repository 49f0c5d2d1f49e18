"""Meta-tensor stand-ins for every (arch x shape) cell (PyTorch port of
``repro/launch/specs.py``).

Each leaf is a ``torch.empty(..., device="meta")``: the shape and dtype
of what the step takes, with no data and no memory, so a step called on
them is a pass over shapes (``launch/dryrun.py``).  The trees follow
``param_meta`` and ``cache_meta`` (``models/lm.py``), and the shapes and
dtypes equal the reference's ``input_specs(cfg, shape, None)``.  The
reference's ``to_shardings`` and ``*_axes`` wait for the production
meshes (ROADMAP.md queue 1, item 20).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, RunShape
from ..models.layers import tree_map
from ..models.lm import _is_meta, cache_meta, param_meta
from ..optim import adamw_init

META = torch.device("meta")


def _empty(shape, dtype):
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return torch.empty(tuple(shape), dtype=dt, device=META)


def _meta_tree(meta, dtype):
    return tree_map(lambda m: _empty(m.shape, dtype), meta, is_leaf=_is_meta)


def _token_shape(cfg: ModelConfig, lead: tuple, seq: int):
    if cfg.frontend == "audio_codebooks":
        return lead + (seq, cfg.n_codebooks)
    return lead + (seq,)


def _text_len(cfg: ModelConfig, shape: RunShape) -> int:
    """The cell's sequence less vision's patch positions."""
    return shape.seq - (cfg.n_patches if cfg.frontend == "vision_patches"
                        else 0)


def batch_specs(cfg: ModelConfig, shape: RunShape):
    """The train batch, leaves shaped (accum, micro, ...)."""
    if shape.kind != "train":
        raise ValueError(f"batch_specs: {shape.name} is a {shape.kind} cell")
    lead = (shape.accum, shape.batch // shape.accum)
    tok = _token_shape(cfg, lead, _text_len(cfg, shape))
    out = {"tokens": _empty(tok, torch.int32),
           "labels": _empty(tok, torch.int32)}
    if cfg.frontend == "vision_patches":
        out["patches"] = _empty(lead + (cfg.n_patches, cfg.d_model),
                                cfg.dtype)
    return out


def state_specs(cfg: ModelConfig):
    """The train state: params in ``param_dtype``, AdamW's m and v in
    ``opt_dtype`` (``adamw_init``), a 0-d int32 ``step``."""
    params = _meta_tree(param_meta(cfg), cfg.param_dtype)
    return {"params": params, "opt": adamw_init(params, cfg.opt_dtype),
            "step": _empty((), torch.int32)}


def serve_param_specs(cfg: ModelConfig):
    """Inference keeps no f32 masters: params arrive in compute dtype."""
    return _meta_tree(param_meta(cfg), cfg.dtype)


def cache_specs(cfg: ModelConfig, batch: int, seq: int):
    """The decode cache; its 0-d ``pos`` int32, as ``init_cache`` makes
    it."""
    return tree_map(
        lambda m: _empty(m.shape, torch.int32 if m.shape == () else
                         cfg.dtype),
        cache_meta(cfg, batch, seq), is_leaf=_is_meta)


def decode_specs(cfg: ModelConfig, shape: RunShape):
    if shape.kind != "decode":
        raise ValueError(f"decode_specs: {shape.name} is a {shape.kind} "
                         "cell")
    return {"tokens": _empty(_token_shape(cfg, (shape.batch,), 1),
                             torch.int32),
            "cache": cache_specs(cfg, shape.batch, shape.seq)}


def prefill_specs(cfg: ModelConfig, shape: RunShape):
    if shape.kind != "prefill":
        raise ValueError(f"prefill_specs: {shape.name} is a {shape.kind} "
                         "cell")
    out = {"tokens": _empty(_token_shape(cfg, (shape.batch,),
                                         _text_len(cfg, shape)),
                            torch.int32)}
    if cfg.frontend == "vision_patches":
        out["patches"] = _empty((shape.batch, cfg.n_patches, cfg.d_model),
                                cfg.dtype)
    return out


def input_specs(cfg: ModelConfig, shape: RunShape):
    """The step's keyword arguments as meta tensors: ``{"state",
    "batch"}`` (train), ``{"params", "tokens"[, "patches"]}`` (prefill)
    or ``{"params", "tokens", "cache"}`` (decode)."""
    if shape.kind == "train":
        return {"state": state_specs(cfg), "batch": batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": serve_param_specs(cfg),
                **prefill_specs(cfg, shape)}
    return {"params": serve_param_specs(cfg), **decode_specs(cfg, shape)}
