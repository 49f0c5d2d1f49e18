"""Step builders (PyTorch port of ``repro/steps.py``): the train step
(gradient accumulation + AdamW) and the serving steps.

The reference jits each step and donates the cache argument so XLA
aliases it in place.  Here the steps run eagerly and update the pool in
place themselves, under the same contract: every cache leaf keeps its
shape and dtype (``models.layers.check_cache_invariant``), so the caller
simply rebinds the returned cache.  The train step likewise updates the
train state in place (params, m, v and ``step``) and returns it.

Tensor-parallel serving: each serve-step maker takes ``mesh=`` (a
``launch.mesh.Mesh``).  Its step then runs the forward under
``sharding_ctx(mesh, TP_SERVE_RULES)`` on this rank's shard of the
weights (``params.shard_params``) and of the caches, whose local shapes
the cache makers give (:func:`local_cache_meta`).  Tokens, positions,
block tables and logits are whole on every rank.  One rank's step is
only part of the computation: ``serve.tp`` runs the same step on every
rank, in one order.

Sharded training: ``make_train_step(cfg, hp, mesh=)`` on any ``D,M``
or ``P,D,M`` mesh runs on this rank's blocks of params, m and v
(``params.shard_train_state``), cut by the reference's
``LOGICAL_RULES``: each weight's ``"fsdp"`` dim over ``data`` (FSDP:
each split leaf gathered over ``data`` where the model uses it and its
gradient summed back to the blocks, ``sharding.fsdp``), its ``"tp"``,
``heads``, ``vocab`` and ``ssm_heads`` dims over ``model`` (tensor
parallelism: the forward runs under ``sharding_ctx(mesh)`` and the
model's collectives carry their backwards, ``models.layers``), the SSD
mixer's leaves by the port's own layout (``models.ssm.TP_LOCAL``).  A
rank computes on its ``micro / (P D)`` rows of every microbatch (the
``"batch"`` rule: pod x data, its block at its pod and data
coordinates, row-major); the ranks of one model group hold the same rows
and labels.  The loss divides by the global count of labelled tokens
(summed over pod and data), whole-on-``data`` leaves' gradients are
summed over ``data``, every leaf's gradient over ``pod`` (the
parameters and moments are whole across pods: ``"fsdp"`` is ``data``
alone), and the clip norm is the whole gradient's (``optim.adamw.
global_norm``).  A MoE layer's experts are split over ``model`` by their
d_ff columns and over ``data`` by their d_model rows, and its
load-balance term is the global batch's (``models.moe``).  Attention
head counts the model axis does not divide train whole on every rank
(``models.attention``); SSD head counts it does not divide raise
(:func:`check_train_mesh`, ROADMAP item 20b).
"""
from __future__ import annotations

import contextlib
import functools

import torch

from .device import resolve_device
from .models import lm
from .models.layers import softmax_xent, tree_leaves, tree_map
from .models.lm import LeafMeta, cache_meta, forward, init_params
from .models.ssm import TP_LOCAL, tp_local_width
from .optim import OptHParams, adamw_init, adamw_update
from .sharding import logical_spec, shard_shape, sharding_ctx
from .sharding.fsdp import (Plan, TPSplit, batch_sum, data_dims, data_sum,
                            pod_sum)

DECODE_RULES = {"heads": ()}  # decode shards cache-seq, not heads

# Tensor-parallel serving: the KV pool shards on *heads* (kv_heads /
# ssm_heads / conv_dim -> model, straight from LOGICAL_RULES) and the
# sequence/page and slot axes stay replicated — the exact inverse of the
# legacy DECODE_RULES layout.  batch -> () keeps tokens, logits, block
# tables and per-slot pos replicated so the engine's host-side mirrors
# read them without a gather.
TP_SERVE_RULES = {"seq_shard": (), "batch": ()}

# Serve-cache leaf name -> logical axes (dense slot pools, paged pools
# and batch=1/bpad prefill row caches all share leaf names and ranks, so
# one table covers every cache the engine moves between steps).  Leaves
# without a head-like dim (MLA latents, pos) resolve to fully replicated
# under TP_SERVE_RULES.
SERVE_CACHE_AXES: dict[str, tuple[str | None, ...]] = {
    "k": (None, "batch", "seq_shard", "kv_heads", None),
    "v": (None, "batch", "seq_shard", "kv_heads", None),
    "ckv": (None, "batch", "seq_shard", None),
    "krope": (None, "batch", "seq_shard", None),
    "conv": (None, "batch", None, "conv_dim"),
    "state": (None, "batch", "ssm_heads", None, None),
}


def serve_cache_axes(name: str, ndim: int) -> tuple[str | None, ...]:
    """Logical axes for one serve-cache leaf (replicated fallback for
    unknown names or rank mismatches — e.g. ``pos``)."""
    axes = SERVE_CACHE_AXES.get(name)
    if axes is None or len(axes) != ndim:
        return (None,) * ndim
    return axes


def model_size(mesh) -> int:
    """The mesh's model axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape["model"]


def data_size(mesh) -> int:
    """The mesh's data axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape.get("data", 1)


def pod_size(mesh) -> int:
    """The mesh's pod axis (1 without a mesh or one)."""
    return 1 if mesh is None else mesh.shape.get("pod", 1)


def batch_size(mesh) -> int:
    """The ways ``batch`` splits under ``LOGICAL_RULES``: pod x data."""
    return pod_size(mesh) * data_size(mesh)


def _check_heads(cfg, n) -> None:
    """Raise where the port cannot lay ``cfg``'s heads out on a model axis
    of ``n``: an SSD head count ``n`` does not divide (ROADMAP item 20b).
    Attention head counts that ``n`` does not divide are whole on every
    rank, as the reference's strict rules replicate them
    (``models.attention``)."""
    for spec in cfg.pattern:
        if spec.kind == "ssm" and cfg.ssm_nheads % n:
            raise NotImplementedError(
                f"{cfg.name}: {cfg.ssm_nheads} SSD heads do not split {n} "
                "ways; replicated SSD heads under tensor parallelism are "
                "not ported (ROADMAP.md queue 1, item 20b)")


def check_tp(cfg, mesh) -> None:
    """Raise where tensor-parallel serving of ``cfg`` on ``mesh`` is not
    ported: a data or pod axis above 1 (a training mesh: serving maps
    ``batch`` to no mesh axis; serving cells on a production mesh are
    ROADMAP item 20b), or heads :func:`_check_heads` refuses.  Head
    counts the model axis does not divide serve, whole on every rank.  A
    no-op without a mesh or with a model axis of 1."""
    n = model_size(mesh)
    if data_size(mesh) > 1 or pod_size(mesh) > 1:
        raise NotImplementedError(
            f"mesh {mesh.shape}: serving splits no data axis and no pod "
            "axis (TP_SERVE_RULES maps batch to no mesh axis); a data axis "
            "above 1 is a training mesh (FSDP), and serving on a "
            "production mesh waits (ROADMAP.md queue 1, item 20b)")
    if n == 1:
        return
    _check_heads(cfg, n)


def _tp(mesh):
    """The context a step's forward runs in: the TP serve rules on
    ``mesh``, or nothing without one."""
    if model_size(mesh) == 1:
        return contextlib.nullcontext()
    return sharding_ctx(mesh, TP_SERVE_RULES)


def local_cache_meta(cfg, batch: int, seq: int, mesh=None):
    """``cache_meta`` with each leaf at this rank's shape under
    ``TP_SERVE_RULES`` (strict): K/V on their KV heads, the SSM state on
    its heads, the conv tail by the port's layout (``models.ssm.
    TP_LOCAL``), MLA latents and ``pos`` whole."""
    meta = cache_meta(cfg, batch, seq)
    n = model_size(mesh)
    if n == 1:
        return meta

    def loc(name, m):
        if name in TP_LOCAL:
            return LeafMeta(m.shape[:-1] + (tp_local_width(name, cfg, n),),
                            m.axes, m.init)
        spec = logical_spec(m.shape, serve_cache_axes(name, len(m.shape)),
                            mesh, TP_SERVE_RULES, strict=True)
        return LeafMeta(shard_shape(m.shape, spec, mesh), m.axes, m.init)

    return {"pos": meta["pos"],
            "blocks": tuple({k: loc(k, m) for k, m in blk.items()}
                            for blk in meta["blocks"])}


def init_cache(cfg, batch: int, seq: int, dtype, device="cuda", mesh=None):
    """``models.lm.init_cache`` at this rank's shapes under ``mesh``."""
    if model_size(mesh) == 1:
        return lm.init_cache(cfg, batch, seq, dtype, device)
    device = resolve_device(device)
    return tree_map(
        lambda m: torch.zeros(m.shape, device=device,
                              dtype=torch.int32 if m.shape == () else dtype),
        local_cache_meta(cfg, batch, seq, mesh), is_leaf=lm._is_meta)


def cast_tree(tree, dtype):
    """Floating leaves to ``dtype`` (a no-op for weights already stored in
    it, as on the card)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return tree_map(lambda x: x.to(dt) if x.is_floating_point() else x,
                    tree)


def init_train_state(cfg, generator: torch.Generator,
                     hp: OptHParams = OptHParams(), device="cuda"):
    """Seeded master params in ``cfg.param_dtype``, zero AdamW moments in
    ``cfg.opt_dtype`` and a 0-d int32 ``step``, made on ``device``."""
    del hp
    device = resolve_device(device)
    params = init_params(cfg, generator, device, dtype=cfg.param_dtype)
    return {"params": params, "opt": adamw_init(params, cfg.opt_dtype),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _token_loss(out, labels, cfg, count=None):
    """The masked token mean: over ``count`` labelled tokens (under FSDP
    the global count, all-reduced: what GSPMD computes for the
    reference's ``jnp.sum(mask)``), by default the labels' own."""
    losses = softmax_xent(out["logits"], labels, cfg.z_loss)
    mask = (labels >= 0).float()
    count = mask.sum() if count is None else count
    return (losses * mask).sum() / count.clamp_min(1.0)


def check_train_mesh(cfg, mesh, micro: int | None = None) -> None:
    """Raise where training ``cfg`` on ``mesh`` is not ported: heads
    :func:`_check_heads` refuses on a model axis above 1 (attention head
    counts the axis does not divide train, whole on every rank), a
    microbatch of ``micro`` rows that ``pod x data`` does not divide
    (deviation: the reference's strict rule would replicate such a
    batch).  A no-op without a mesh or on a mesh of one rank."""
    if mesh is None or mesh.size == 1:
        return
    if model_size(mesh) > 1:
        _check_heads(cfg, model_size(mesh))
    if micro is not None and micro % batch_size(mesh):
        raise NotImplementedError(
            f"a microbatch of {micro} rows does not split "
            f"{batch_size(mesh)} ways over pod x data (the reference would "
            "replicate it; the port needs micro divisible by pod x data)")


def tp_splits(cfg, mesh):
    """Per parameter leaf of ``cfg``, its split over ``model`` on
    ``mesh`` (a ``sharding.fsdp.TPSplit``) or None where it is whole on
    every model rank: the dim its logical axes put on ``model`` under
    ``LOGICAL_RULES``, strictly; the SSD mixer's leaves by
    ``models.ssm.TP_LOCAL`` (the last dim: one entry per head or inner
    channel, or this rank's x channels and every B and C channel).  All
    None on a model axis of 1."""
    n = model_size(mesh)

    def split(m, name, ssm):
        if n == 1:
            return None
        if ssm and name in TP_LOCAL:
            return TPSplit(len(m.shape) - 1, cfg.d_inner
                           if TP_LOCAL[name] == "conv" else None)
        spec = logical_spec(m.shape, m.axes, mesh, strict=True)
        for d, part in enumerate(spec):
            if "model" in ((part,) if isinstance(part, str) else part or ()):
                return TPSplit(d)
        return None

    def walk(m, name="", ssm=False):
        if isinstance(m, LeafMeta):
            return split(m, name, ssm)
        if isinstance(m, dict):
            return {k: walk(v, k, ssm) for k, v in m.items()}
        return tuple(walk(v) for v in m)

    meta = lm.param_meta(cfg)
    out = {k: walk(v, k) for k, v in meta.items() if k != "blocks"}
    out["blocks"] = tuple(
        {part: {k: walk(v, k, part == "mixer" and spec.kind == "ssm")
                for k, v in blk[part].items()} for part in blk}
        for spec, blk in zip(cfg.pattern, meta["blocks"]))
    return out


def train_plan(cfg, mesh):
    """The layout of ``cfg``'s parameters on ``mesh``
    (``sharding.fsdp.Plan``: each leaf's data dim and model split), or
    None where nothing is split: no mesh, or one rank.  Raises where
    :func:`check_train_mesh` does."""
    check_train_mesh(cfg, mesh)
    if mesh is None or mesh.size == 1:
        return None
    return Plan(mesh, data_dims(lm.param_meta(cfg), mesh),
                tp_splits(cfg, mesh))


def _on(batch, device):
    """Batch leaves (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_grad_step(cfg, mesh=None):
    """(params, batch) -> (grads, loss): the gradient half of the train
    step.  Batch leaves are (accum, micro, ...); each microbatch's
    ``loss + 0.01 * aux / n_layers`` is differentiated on
    ``cast_tree(params, cfg.dtype)``, and the gradients of the master
    params are summed in their own dtype (f32) and divided by ``accum``.
    ``loss`` is the microbatches' mean token loss (a 0-d f32 tensor).
    ``batch["patches"]`` (vision), when present, rides each microbatch;
    audio labels are (…, K), one per codebook, as the tokens.

    On a mesh (``mesh``; the layout is the step's ``plan``), ``params``
    are this rank's blocks and so are the gradients; the rank computes on
    rows ``[c m / D, (c + 1) m / D)`` of each microbatch of ``m`` rows
    (``c`` its data coordinate, ``D`` the axis), divides by the
    microbatch's global count of labelled tokens, and sums the whole-on-
    ``data`` leaves' gradients and the loss over ``data``.  On a model
    axis above 1 the forward and its backward run under
    ``sharding_ctx(mesh)`` (the reference's ``LOGICAL_RULES``).  ``aux``
    is the same on every rank: each MoE layer's term takes its means over
    the global batch (``models.moe.global_stats``), and each rank
    differentiates it through its own rows only, so the gradients' sum
    over ``data`` is the global term's gradient."""
    plan = train_plan(cfg, mesh)
    tp = (functools.partial(sharding_ctx, mesh) if model_size(mesh) > 1
          else contextlib.nullcontext)

    def grad_step(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(
            p.is_floating_point()), params)
        device = tree_leaves(params)[0].device
        batch = _on(batch, device)
        accum, micro = batch["tokens"].shape[:2]
        counts = None
        if plan is not None:
            check_train_mesh(cfg, mesh, micro)
            rows = micro // batch_size(mesh)
            first = (mesh.coords["pod"] * data_size(mesh)
                     + mesh.coords["data"]) * rows
            batch = {k: v[:, first:first + rows] for k, v in batch.items()}
            counts = batch_sum((batch["labels"] >= 0).reshape(
                accum, -1).sum(1).float(), mesh)
        lsum = torch.zeros((), dtype=torch.float32, device=device)
        with torch.enable_grad(), tp():
            for a in range(accum):
                out = forward(cast_tree(live, cfg.dtype), cfg,
                              batch["tokens"][a], mode="train",
                              patches=(batch["patches"][a]
                                       if "patches" in batch else None),
                              fsdp=plan)
                loss = _token_loss(out, batch["labels"][a], cfg,
                                   None if counts is None else counts[a])
                total = loss + 0.01 * out["aux"] / max(cfg.n_layers, 1)
                del out
                total.backward()
                lsum += loss.detach()
        grads = tree_map(lambda p: p.grad.div_(accum) if p.grad is not None
                         else torch.zeros_like(p, dtype=torch.float32), live)
        if plan is not None:
            _sum_whole(grads, plan)
            _sum_pods(grads, plan)
            lsum = batch_sum(lsum.reshape(1), mesh)[0]
        return grads, lsum / accum

    grad_step.plan = plan
    return grad_step


def _sum_whole(grads, plan):
    """The whole-on-``data`` leaves' gradients summed over ``data`` in
    place, in one all-reduce of their concatenation (none on a data axis
    of 1)."""
    whole = [g for g, d in zip(tree_leaves(grads), tree_leaves(plan.dims))
             if d is None]
    if not whole or data_size(plan.mesh) == 1:
        return
    flat = data_sum(torch.cat([g.reshape(-1) for g in whole]), plan.mesh)
    for g, part in zip(whole, flat.split([g.numel() for g in whole])):
        g.copy_(part.view_as(g))


def _sum_pods(grads, plan):
    """Every leaf's gradient summed over ``pod`` in place, in one
    all-reduce of their concatenation (none without a pod axis above 1):
    the parameters are whole across pods, each pod's gradients a partial
    sum over its rows of the batch."""
    if pod_size(plan.mesh) == 1:
        return
    leaves = tree_leaves(grads)
    flat = pod_sum(torch.cat([g.reshape(-1) for g in leaves]), plan.mesh)
    for g, part in zip(leaves, flat.split([g.numel() for g in leaves])):
        g.copy_(part.view_as(g))


def make_train_step(cfg, hp: OptHParams = OptHParams(), mesh=None):
    """(state, batch) -> (state, metrics): one optimizer step over the
    batch's ``accum`` microbatches (``make_grad_step``) and AdamW, the
    state updated in place (``step`` too).  Metrics: ``loss``,
    ``grad_norm`` and ``lr``, 0-d f32 tensors on the state's device.  On
    a mesh the state is this rank's shard (``params.
    shard_train_state``), the batch whole, and every rank of the mesh
    runs the step (``serve.tp.Session``)."""
    grad_step = make_grad_step(cfg, mesh)

    def train_step(state, batch):
        grads, loss = grad_step(state["params"], batch)
        _, _, metrics = adamw_update(grads, state["opt"], state["params"],
                                     state["step"], hp, grad_step.plan)
        del grads
        metrics["loss"] = loss
        state["step"].add_(1)
        return state, metrics

    return train_step


def make_prefill_step(cfg, cache_len=None, mesh=None):
    """(params, tokens, patches=None) -> (row cache, last logits)."""
    check_tp(cfg, mesh)

    def prefill_step(params, tokens, patches=None):
        with _tp(mesh):
            out = forward(cast_tree(params, cfg.dtype), cfg, tokens,
                          mode="prefill", patches=patches,
                          cache_len=cache_len)
        return out["cache"], out["logits"]

    return prefill_step


def make_serve_step(cfg, mesh=None):
    """One decode step at the cache's scalar ``pos``:
    (params, cache, tokens) -> (next_tokens, cache)."""
    check_tp(cfg, mesh)

    def serve_step(params, cache, tokens):
        with _tp(mesh):
            out = forward(cast_tree(params, cfg.dtype), cfg, tokens,
                          mode="decode", pos=cache["pos"], cache=cache)
        return out["logits"].argmax(dim=-1).int(), out["cache"]

    return serve_step


def greedy_oneshot(prefill, serve_step, params, prompts, patches, gen):
    """Batched prefill, then ``gen - 1`` decode ticks; (B, gen) tokens —
    the reference the engine's tokens are held to.  Under a mesh, pass
    the steps and params of a ``serve.tp.Session``: each call then runs
    on every rank."""
    cache, logits = prefill(params, prompts, patches)
    tok = logits.argmax(dim=-1).int()
    out = [tok]
    for _ in range(gen - 1):
        tok, cache = serve_step(params, cache, tok)
        out.append(tok)
    return torch.cat(out, dim=1)


# ------------------------------------------------- continuous-batching steps
def init_slot_cache(cfg, slots: int, cache_len: int, dtype, device="cuda",
                    mesh=None):
    """Batched cache for ``slots`` serve slots with a (slots,) ``pos``
    (this rank's shapes under ``mesh``)."""
    cache = init_cache(cfg, slots, cache_len, dtype, device, mesh)
    cache["pos"] = torch.zeros((slots,), dtype=torch.int32,
                               device=cache["pos"].device)
    return cache


def paged_names(spec, cache_len: int) -> frozenset:
    """Leaf names of this pattern spec whose cache is paged: the linear,
    cache_len-long attention leaves."""
    if spec.kind == "ssm":
        return frozenset()
    if spec.attn == "mla":
        return frozenset(("ckv", "krope"))
    if spec.window is not None and spec.window < cache_len:
        return frozenset()
    return frozenset(("k", "v"))


def chunkable(cfg, cache_len: int) -> bool:
    """Can prefill be chunked bit-exactly for this config?"""
    for spec in cfg.pattern:
        if spec.kind == "ssm" or spec.mlp == "moe":
            return False
        if spec.window is not None and spec.window < cache_len:
            return False
    return True


def speculatable(cfg, cache_len: int) -> bool:
    """Can draft-and-verify speculative decoding be exact for this config?
    The verify window needs what chunked prefill needs (:func:`chunkable`:
    no MoE capacity coupling, no SSD scan, no sliding-window ring shorter
    than ``cache_len``) and one greedy token per position (not the audio
    frontend's codebook vector)."""
    return chunkable(cfg, cache_len) and cfg.frontend != "audio_codebooks"


def init_paged_slot_cache(cfg, slots: int, cache_len: int, dtype,
                          page_size: int, num_pages: int, device="cuda",
                          mesh=None):
    """Slot cache whose linear attention leaves are paged pools of shape
    (n_repeats, num_pages, page_size, *tail).  Page 0 is the garbage
    page: dead slots and unallocated logical pages point there.  Under
    ``mesh`` the tails are this rank's (its KV heads); every rank holds
    every page."""
    if cache_len % page_size:
        raise ValueError(f"page_size {page_size} must divide cache_len "
                         f"{cache_len}")
    if num_pages < 2:
        raise ValueError("need at least one usable page + garbage page 0")
    meta = local_cache_meta(cfg, slots, cache_len, mesh)
    dev = torch.device(device)
    blocks = []
    for spec, bm in zip(cfg.pattern, meta["blocks"]):
        paged = paged_names(spec, cache_len)
        leaves = {}
        for name, m in bm.items():
            shape = m.shape
            if name in paged:
                shape = (shape[0], num_pages, page_size) + shape[3:]
            leaves[name] = torch.zeros(shape, dtype=dtype, device=dev)
        blocks.append(leaves)
    return {"pos": torch.zeros((slots,), dtype=torch.int32, device=dev),
            "blocks": tuple(blocks)}


def make_pool_step(cfg, *, slots: int, cache_len: int, dtype: str,
                   page_size: int | None = None, device="cuda", mesh=None):
    """(num_pages) -> a fresh slot pool on ``device`` (paged with
    ``page_size`` and ``num_pages`` pages, dense without), at this rank's
    shapes under ``mesh``: how a tensor-parallel engine makes its pool on
    every rank."""
    dt = getattr(torch, dtype)

    def pool_step(num_pages=None):
        if page_size is None:
            return init_slot_cache(cfg, slots, cache_len, dt, device, mesh)
        return init_paged_slot_cache(cfg, slots, cache_len, dt, page_size,
                                     num_pages, device, mesh)

    return pool_step


def make_row_cache_step(cfg, *, cache_len: int, dtype: str, device="cuda",
                        mesh=None):
    """(batch) -> a zeroed dense row cache of ``batch`` rows (the first
    chunk of a chunked prefill writes into it), at this rank's shapes
    under ``mesh``."""
    dt = getattr(torch, dtype)

    def rows_step(batch):
        return init_cache(cfg, int(batch), cache_len, dt, device, mesh)

    return rows_step


def make_batched_insert_step(cfg, *, cache_len: int,
                             page_size: int | None = None, mesh=None):
    """Insert row ``row`` of a batched prefill cache into slot ``slot`` of
    the shared cache, in place.

    Dense: (cache, rows_cache, row, slot) -> cache.
    Paged: (cache, rows_cache, row, slot, table_row) -> cache, where
    ``table_row`` holds the slot's physical page ids; unreserved logical
    pages point at garbage page 0, where their writes collide (which one
    lands is unspecified — page 0 is never read at a valid position).
    ``mesh``: accepted for the tensor-parallel dispatch; the rows and the
    pool are this rank's already."""
    del mesh

    @torch.no_grad()
    def insert_step(cache, rows_cache, row, slot, table_row=None):
        for spec, cb, rb in zip(cfg.pattern, cache["blocks"],
                                rows_cache["blocks"]):
            paged = (paged_names(spec, cache_len)
                     if page_size is not None else frozenset())
            for name, c in cb.items():
                r = rb[name][:, row]                # (n_rep, cache_len, ...)
                if name in paged:
                    pps = cache_len // page_size
                    rr = r.reshape((r.shape[0], pps, page_size)
                                   + tuple(r.shape[2:]))
                    c[:, table_row.long()] = rr.to(c.dtype)
                else:
                    c[:, slot] = r.to(c.dtype)
        cache["pos"][slot] = rows_cache["pos"].to(torch.int32)
        return cache

    return insert_step


def make_prefix_gather_step(cfg, *, cache_len: int, page_size: int,
                            mesh=None):
    """The read half of a prefix-cache hit: a fresh batch-1 dense row
    cache gathered from shared KV pages,

        (cache, table_row, pos) -> row_cache

    ``table_row`` is a (pages_per_slot,) physical page vector whose
    leading entries are the matched prefix pages (plus the copy-on-write
    fork source) and whose tail points at garbage page 0; ``pos`` (a host
    int) is the number of valid prefix tokens.  Positions past ``pos``
    hold garbage-page content, which the tail's chunks overwrite or the
    position mask excludes.  A pure read of the pool: the caller enqueues
    it before any later step that writes those pages.  ``mesh``: accepted
    for the tensor-parallel dispatch (the pool is this rank's)."""
    del mesh
    if cache_len % page_size:
        raise ValueError(f"page_size {page_size} must divide cache_len "
                         f"{cache_len}")
    assert chunkable(cfg, cache_len), (
        f"{cfg.name}: prefix-cache gather rides the chunked-prefill "
        "machinery — non-chunkable configs bypass the prefix cache")
    pps = cache_len // page_size

    @torch.no_grad()
    def gather_step(cache, table_row, pos):
        blocks = []
        for spec, cb in zip(cfg.pattern, cache["blocks"]):
            paged = paged_names(spec, cache_len)
            assert set(cb) == paged, (spec, set(cb), paged)
            idx = table_row.long()
            blocks.append({
                name: c[:, idx].reshape((c.shape[0], 1, pps * page_size)
                                        + tuple(c.shape[3:]))
                for name, c in cb.items()})
        return {"pos": torch.full((), int(pos), dtype=torch.int32,
                                  device=table_row.device),
                "blocks": tuple(blocks)}

    return gather_step


def make_prefill_chunk_step(cfg, cache_len: int | None = None, mesh=None):
    """Cache-append prefill continuation (chunked prefill):

        (params, row_cache, tokens, q_off) -> (row_cache, last logits)

    ``row_cache`` is a dense (B, cache_len) cache (start from
    ``init_cache``), updated in place; ``tokens`` is the (B, C) chunk
    written at positions ``[q_off, q_off + C)`` (``q_off`` a host int);
    a vision prompt's first chunk carries its ``patches`` in front, so it
    covers ``n_patches + C`` positions from ``q_off``.
    Keywords ``attn_extent`` (the key extent each chunk attends over) and
    ``want_logits`` (False: a non-final chunk skips the LM head, and the
    logits come back None).  The last chunk's logits equal the one-shot
    prefill's within rounding; MoE, SSM and sliding-window rings shorter
    than ``cache_len`` cannot chunk exactly (:func:`chunkable`)."""
    assert cache_len is not None
    assert chunkable(cfg, cache_len), (
        f"{cfg.name}: chunked prefill needs linear-cache attention blocks "
        "(no MoE, no SSM, no SWA ring shorter than cache_len)")
    check_tp(cfg, mesh)

    def chunk_step(params, row_cache, tokens, q_off, patches=None, *,
                   attn_extent=None, want_logits=True):
        with _tp(mesh):
            out = forward(cast_tree(params, cfg.dtype), cfg, tokens,
                          mode="prefill_chunk", pos=int(q_off),
                          cache=row_cache, patches=patches,
                          cache_len=cache_len, attn_extent=attn_extent,
                          want_logits=want_logits)
        return out["cache"], out["logits"]

    return chunk_step


def make_decode_step(cfg, *, cache_len: int | None = None,
                     page_size: int | None = None,
                     paged_kernel: bool = False, mesh=None):
    """Masked continuous-batching decode over the slot pool:
    (params, cache, tokens, active[, table]) -> (next_tokens, cache).

    ``cache["pos"]`` is (slots,); ``active`` a (slots,) bool mask.  Dead
    slots emit token 0 and keep their ``pos``.  With ``page_size`` set the
    linear attention leaves are paged pools read through ``table``
    (slots, pages_per_slot); ``paged_kernel=True`` sends paged attention
    through the CUDA kernel (on CUDA tensors) instead of the dense
    gather.  The pool is updated in place; the returned cache holds the
    same pool tensors and a fresh ``pos``."""
    paged = page_size is not None
    if paged and (cache_len is None or cache_len % page_size):
        raise ValueError("paged decode needs cache_len divisible by "
                         "page_size")
    if paged_kernel and not paged:
        raise ValueError("paged_kernel needs a paged cache (page_size set)")
    check_tp(cfg, mesh)

    def decode_step(params, cache, tokens, active, table=None):
        pages = ({"table": table, "page_size": page_size,
                  "cache_len": cache_len, "kernel": paged_kernel}
                 if paged else None)
        with _tp(mesh):
            out = forward(cast_tree(params, cfg.dtype), cfg, tokens,
                          mode="decode", pos=cache["pos"], cache=cache,
                          pages=pages)
        nxt = out["logits"].argmax(dim=-1).int()
        amask = active.reshape((-1,) + (1,) * (nxt.dim() - 1))
        nxt = torch.where(amask, nxt, 0).int()
        new_cache = out["cache"]
        new_cache["pos"] = torch.where(active, cache["pos"] + 1,
                                       cache["pos"])
        return nxt, new_cache

    if not paged:
        def decode_step_dense(params, cache, tokens, active):
            return decode_step(params, cache, tokens, active)
        return decode_step_dense
    return decode_step


def make_verify_step(cfg, *, cache_len: int, page_size: int | None = None,
                     mesh=None):
    """Draft-and-verify speculative decode over the slot pool:

        (params, cache, tokens, pos, n_tok[, table]) -> (argmax, cache)

    ``tokens`` (slots, S): per slot the last committed token followed by
    up to S - 1 drafted tokens, right-padded; ``pos`` (slots,) int32: the
    cache position of the window's first token (the last committed
    token's K/V is written there, as decode does); ``n_tok`` (slots,)
    int32: valid lanes per slot (0: a dead slot, none of its lanes
    written).  The whole window is appended and scored in one dispatch:
    the (slots, S) int32 argmax at lane j is the token greedy decode
    emits after ``tokens[:, :j + 1]``.  The cache's ``pos`` comes back
    unchanged (the engine owns acceptance).  Rejected lanes need no
    rollback: their writes lie past the committed extent, which every
    later read masks out and the next window overwrites.  With
    ``page_size`` the linear attention leaves are paged pools read
    through ``table``, always by the gather path: the paged kernel is a
    one-query decode and stays on the decode tick, as in the reference."""
    paged = page_size is not None
    if paged and cache_len % page_size:
        raise ValueError("paged verify needs cache_len divisible by "
                         "page_size")
    if not speculatable(cfg, cache_len):
        raise ValueError(
            f"{cfg.name}: speculative decoding needs a chunk-exact config "
            "(no MoE, no SSM, no SWA ring shorter than cache_len) and a "
            "scalar greedy-token frontend")
    check_tp(cfg, mesh)

    def verify_step(params, cache, tokens, pos, n_tok, table=None):
        pages = ({"table": table, "page_size": page_size,
                  "cache_len": cache_len, "kernel": False}
                 if paged else None)
        with _tp(mesh):
            out = forward(cast_tree(params, cfg.dtype), cfg, tokens,
                          mode="verify", pos=pos, cache=cache,
                          cache_len=cache_len, pages=pages, n_tok=n_tok)
        return out["logits"].argmax(dim=-1).int(), out["cache"]

    if not paged:
        def verify_step_dense(params, cache, tokens, pos, n_tok):
            return verify_step(params, cache, tokens, pos, n_tok)
        return verify_step_dense
    return verify_step


__all__ = ["cast_tree", "make_prefill_step", "make_serve_step",
           "greedy_oneshot", "init_slot_cache", "init_paged_slot_cache",
           "paged_names", "chunkable", "speculatable",
           "make_batched_insert_step", "make_prefix_gather_step",
           "make_prefill_chunk_step", "make_decode_step",
           "make_verify_step", "make_pool_step", "make_row_cache_step",
           "init_cache", "TP_SERVE_RULES", "DECODE_RULES",
           "SERVE_CACHE_AXES", "serve_cache_axes", "local_cache_meta",
           "check_tp", "check_train_mesh", "pod_size", "batch_size",
           "tp_splits", "train_plan",
           "data_size",
           "make_grad_step", "make_train_step", "init_train_state"]
