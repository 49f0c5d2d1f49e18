"""Meta-tensor stand-ins for every (arch x shape) cell (PyTorch port of
``repro/launch/specs.py``).

Each leaf is a ``torch.empty(..., device="meta")``: the shape and dtype
of what the step takes, with no data and no memory, so a step called on
them is a pass over shapes (``launch/dryrun.py``).  The trees follow
``param_meta`` and ``cache_meta`` (``models/lm.py``), and the shapes and
dtypes equal the reference's ``input_specs(cfg, shape, None)``.

``state_axes``, ``batch_axes`` and ``cache_axes`` are the reference's
logical-axes trees, and ``to_shardings`` maps them, leaf by leaf, to the
strict spec tuples of ``sharding.logical_spec`` (a mesh axis, a tuple of
them or None per dim: what the reference hands to ``jax.jit``).
``input_specs(cfg, shape, mesh)`` with a mesh (a ``launch.mesh.
LayoutMesh`` of the production meshes) gives this rank's local shapes:
the train state cut by ``params.shard_train_state`` (the step's own
layout: the rules' specs, but the SSD mixer's ``TP_LOCAL`` leaves) and
the batch by its rows over pod x data.  Serving cells on a mesh raise
(ROADMAP.md item 20b).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, RunShape
from ..models.layers import tree_map
from ..models.lm import _is_meta, cache_meta, param_meta
from ..optim import adamw_init
from ..params import shard_train_state
from ..sharding import logical_spec, shard_shape

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


def batch_axes(cfg: ModelConfig):
    """The train batch's logical axes (the reference's)."""
    out = {"tokens": (None, "batch", "seq"), "labels": (None, "batch", "seq")}
    if cfg.frontend == "audio_codebooks":
        out = {k: v + (None,) for k, v in out.items()}
    if cfg.frontend == "vision_patches":
        out["patches"] = (None, "batch", None, "embed")
    return out


def _axes(meta):
    return tree_map(lambda m: tuple(m.axes), meta, is_leaf=_is_meta)


def state_axes(cfg: ModelConfig):
    """The train state's logical axes: the params' (``param_meta``), the
    same for m and v, none for ``step``."""
    ax = _axes(param_meta(cfg))
    return {"params": ax, "opt": {"m": ax, "v": ax}, "step": ()}


def cache_axes(cfg: ModelConfig, batch: int, seq: int):
    """The decode cache's logical axes (``cache_meta``)."""
    return _axes(cache_meta(cfg, batch, seq))


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def to_shardings(axes_tree, specs_tree, mesh, rules=None):
    """(logical-axes tree, specs tree) -> a tree of spec tuples: each
    leaf's ``logical_spec`` on ``mesh`` under ``rules``, strict (a dim an
    axis does not divide stays whole on it), the reference's argument
    shardings."""
    def walk(ax, spec):
        if _is_axes(ax):
            return logical_spec(tuple(spec.shape), ax, mesh, rules,
                                strict=True)
        if isinstance(ax, dict):
            return {k: walk(ax[k], spec[k]) for k in ax}
        return tuple(walk(a, x) for a, x in zip(ax, spec))

    return walk(axes_tree, specs_tree)


def local_batch(cfg: ModelConfig, shape: RunShape, mesh):
    """The train batch at this rank's shapes on ``mesh``: each leaf cut
    by its rule's spec (the batch over pod x data)."""
    specs = batch_specs(cfg, shape)
    parts = to_shardings(batch_axes(cfg), specs, mesh)
    return {k: _empty(shard_shape(tuple(v.shape), parts[k], mesh), v.dtype)
            for k, v in specs.items()}


def input_specs(cfg: ModelConfig, shape: RunShape, mesh=None):
    """The step's keyword arguments as meta tensors: ``{"state",
    "batch"}`` (train), ``{"params", "tokens"[, "patches"]}`` (prefill)
    or ``{"params", "tokens", "cache"}`` (decode); with ``mesh``, this
    rank's local shapes (the module's docstring)."""
    if shape.kind == "train":
        if mesh is None:
            return {"state": state_specs(cfg),
                    "batch": batch_specs(cfg, shape)}
        return {"state": shard_train_state(state_specs(cfg), cfg, mesh),
                "batch": local_batch(cfg, shape, mesh)}
    if mesh is not None:
        raise NotImplementedError(
            f"{shape.name} on a mesh: serving cells on a production mesh "
            "wait for ROADMAP.md item 20b")
    params = serve_param_specs(cfg)
    if shape.kind == "prefill":
        return {"params": params, **prefill_specs(cfg, shape)}
    return {"params": params, **decode_specs(cfg, shape)}
