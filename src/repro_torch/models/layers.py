"""Shared layers: norms, rope, MLP, embeddings, paging, the loss (PyTorch
port of ``repro/models/layers.py``).

``rms_norm`` is the kernel wrapper: the Triton kernel for CUDA tensors,
the plain version for CPU ones; ``gated_rms_norm`` goes through it too.

Tensor parallelism (``repro_torch.launch.mesh``, under the serve or
train steps' ``sharding_ctx``): each rank holds its shard of the weights
and computes on it, and the collectives the reference's GSPMD inserts
are written out here, over the mesh's ``model`` group.  The SwiGLU MLP
is row-parallel (local ``w_gate``/``w_up`` columns, local ``w_down``
rows, one all-reduce), the embedding vocab-parallel (a masked local
lookup, one all-reduce), the LM head column-parallel (local vocab
columns, one all-gather), so every rank ends with the whole logits and
greedy argmaxes agree across ranks.  A dim the rules cannot split evenly
stays whole (:func:`tp_shards` is 1) and takes no collective.

In training each collective is an autograd op, and the residual stream
and its gradient are whole and equal on every model rank:

* :func:`tp_all_reduce` (a row-parallel product's partials, the
  embedding's rows): forward the f32 sum, rounded once; backward the
  identity, since every rank's consumer reads the same sum;
* :func:`tp_enter` at each column-parallel input (a tensor whole on
  every rank that meets this rank's heads or columns): forward the
  identity; backward the all-reduce of its gradient, each rank's a
  partial sum over its own heads;
* :func:`tp_all_gather` (the vocab-split logits): backward keeps this
  rank's slice, since every rank computes the same loss on the whole
  logits; :func:`tp_gather_cols` the same for several tensors' column
  blocks in one collective (an attention layer's heads whole on every
  rank from weights cut mid-head, ``models.attention``);
* :func:`gated_rms_norm`'s statistic: its forward all-reduce is taken
  without a gradient, and the norm's backward (``rms_norm_rstd`` under
  autograd) all-reduces each row's term ``s_loc`` instead
  (:func:`_norm_dot_sum`): the statistic's consumers are rank-local, so
  the backward of its all-reduce is an all-reduce, not the identity.

Each collective is counted apart, forward and backward, with its bytes:
``tp_all_reduce.calls`` and ``tp_all_gather.calls`` (forward; the serve
paths run only these), ``tp_enter.calls`` and ``tp_norm_dot.calls``
(backward).  Each op captures its mesh when it is recorded, since a
backward may run on autograd's device thread, where no
``sharding_ctx`` is open.

The modality frontends are the reference's stubs: ``audio_codebooks``
sums K codebook embeddings into one stream and emits K heads'
logits; ``vision_patches`` embeds text as the token LMs do (its
precomputed patch embeddings are prepended in ``lm.forward``); both
take ``sinusoidal_pos`` where the config says so.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import rms_norm, rms_norm_rstd
from ..kernels.counter import LaunchCounter
from ..sharding import (current_mesh, current_rules, logical_spec,
                        resolved_axes)

__all__ = ["rms_norm", "gated_rms_norm", "check_cache_invariant",
           "tp_shards", "tp_size", "tp_coord", "Heads", "tp_heads",
           "tp_ssm_heads", "tp_all_reduce", "tp_all_gather",
           "tp_gather_cols", "tp_enter",
           "page_gather", "page_scatter", "page_scatter_window",
           "rope_freqs", "apply_rope", "sinusoidal_pos", "mlp_dense",
           "embed_tokens", "lm_logits", "softmax_xent", "tree_leaves",
           "tree_map"]


# ------------------------------------------------------ tensor parallelism
def tp_shards(dim: int, logical: str = "tp") -> int:
    """How many ways the active mesh splits a dim of size ``dim`` with
    logical axis ``logical`` under the active rules, strictly (1 where it
    does not divide): the layout ``params.shard_params`` cut the weights
    to.  1 without a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    part = logical_spec((dim,), (logical,), mesh, current_rules(),
                        strict=True)[0]
    if part is None:
        return 1
    n = 1
    for a in (part,) if isinstance(part, str) else part:
        n *= mesh.shape[a]
    return n


def tp_coord(logical: str = "tp") -> int:
    """This rank's block index on the mesh axes ``logical`` resolves to
    (row-major over them; 0 without a mesh)."""
    mesh, k = current_mesh(), 0
    for a in resolved_axes(logical):
        k = k * mesh.shape[a] + mesh.coords[a]
    return k


def tp_size(logical: str = "tp") -> int:
    """The size of the mesh axes ``logical`` resolves to under the active
    context (1 without a mesh)."""
    mesh, n = current_mesh(), 1
    for a in resolved_axes(logical):
        n *= mesh.shape[a]
    return n


class Heads(NamedTuple):
    """One attention layer's heads on this rank (:func:`tp_heads`): ``h``
    query heads from global head ``q0``, ``hkv`` KV heads from global KV
    head ``kv0``, ``group`` the model's query heads per KV head.  A head
    count the model axis divides is split (``h = H / n``); one it does not
    divide is whole on every rank (``h = H``, ``q0 = 0``), as the
    reference's strict rules replicate it."""
    h: int
    hkv: int
    q0: int
    kv0: int
    group: int

    @property
    def reads(self) -> tuple[int, int]:
        """(first, count) of this rank's ``hkv`` KV heads that its query
        heads read: all of them, but where the query heads split and the
        KV heads do not (one KV head, ``q0 // group``)."""
        if not self.hkv:
            return 0, 0
        first = self.q0 // self.group - self.kv0
        return first, max(1, self.h // self.group)


def tp_heads(n_heads: int, n_kv_heads: int | None = None) -> Heads:
    """This rank's heads of an attention layer of ``n_heads`` query and
    ``n_kv_heads`` KV heads (none for MLA) under the active context: each
    count split ``n`` ways on a model axis of ``n`` that divides it (the
    reference's ``heads`` / ``kv_heads`` -> model), else whole on every
    rank.  Where the query heads split and the KV heads do not, a rank's
    query heads must all read one KV head (``group`` a multiple of
    ``H / n``, as for every ``REGISTRY`` family on 16); where they would
    read KV heads of uneven groups, the query heads are whole on every
    rank too."""
    hkv_all = n_kv_heads or 0
    group = n_heads // hkv_all if hkv_all else 1
    n = tp_size("heads")
    k = tp_coord("heads") if n > 1 else 0
    h, q0 = (n_heads // n, k * (n_heads // n)) if n_heads % n == 0 \
        else (n_heads, 0)
    hkv, kv0 = ((hkv_all // n, k * (hkv_all // n)) if hkv_all % n == 0
                else (hkv_all, 0))
    if hkv_all and h < n_heads and hkv == hkv_all and group % h:
        h, q0 = n_heads, 0
    return Heads(h, hkv, q0, kv0, group)


def tp_ssm_heads(count: int) -> int:
    """The split of an SSD mixer's ``count`` heads: the model axis under
    the active context (1 without a mesh).  A count it does not divide
    raises: SSD heads replicated under tensor parallelism are not ported
    (ROADMAP.md queue 1, item 20b)."""
    n = tp_size("ssm_heads")
    if n > 1 and count % n:
        raise NotImplementedError(
            f"{count} SSD heads do not split {n} ways: replicated SSD heads "
            "under tensor parallelism are not ported (ROADMAP.md queue 1, "
            "item 20b)")
    return n


def _count(op, t):
    op.calls.add()
    op.bytes.add(t.numel() * t.element_size())


def _model_sum_f32(x, mesh):
    """``x`` summed over the model ranks in f32, rounded once to x's
    dtype (a copy: x is not written)."""
    buf = x.to(torch.float32, copy=True).contiguous()
    mesh.all_reduce(buf, "model")
    return buf.to(x.dtype)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        _count(tp_all_reduce, x)
        return _model_sum_f32(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def tp_all_reduce(x):
    """Sum ``x`` over the model axis (one collective, counted), rounded
    once to x's dtype: a row-parallel product's partials (each in x's
    dtype) are summed in f32 on every mesh size, then rounded.  Under
    autograd its backward is the identity."""
    return _AllReduce.apply(x, current_mesh())


def _enter_sum(grad, mesh):
    """:func:`tp_enter`'s backward: the gradient summed over the model
    ranks in f32, rounded once (counted)."""
    _count(tp_enter, grad)
    return _model_sum_f32(grad, mesh)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _enter_sum(grad, ctx.mesh), None


def tp_enter(x):
    """Where ``x``, whole and equal on every model rank, enters this
    rank's heads or columns: the identity, whose backward all-reduces the
    gradient over the model axis (each rank's is a partial sum).  The
    identity itself, recording nothing, off a model axis or where
    autograd does not record ``x``."""
    mesh = current_mesh()
    if mesh is None or mesh.shape["model"] == 1 or not (
            torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Enter.apply(x, mesh)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.k, ctx.size = dim, mesh.coords["model"], x.shape[dim]
        out = torch.cat(mesh.all_gather(x, "model"), dim=dim)
        _count(tp_all_gather, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.k * ctx.size, ctx.size), None, None


def tp_all_gather(x, dim: int = -1):
    """Every model rank's ``x`` concatenated along ``dim`` in rank order
    (one collective, counted).  Under autograd its backward keeps this
    rank's slice."""
    return _AllGather.apply(x, dim, current_mesh())


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, mesh):
        ctx.k = mesh.coords["model"]
        out = torch.stack(mesh.all_gather(flat, "model"))
        _count(tp_all_gather, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.k], None


def tp_gather_cols(*ts):
    """Each of ``ts`` (``(..., c)``: this rank's block of ``c`` columns)
    made whole, ``(..., n c)``, every model rank's block in rank order, in
    one collective for all of them (counted as a :func:`tp_all_gather`).
    Under autograd each keeps this rank's block of its gradient, which is
    right where that gradient is whole and equal on every rank."""
    mesh = current_mesh()
    n = mesh.shape["model"]
    rows = _GatherRows.apply(torch.cat([t.reshape(-1) for t in ts]), mesh)
    out, off = [], 0
    for t in ts:
        part = rows[:, off:off + t.numel()].reshape((n,) + tuple(t.shape))
        out.append(part.movedim(0, -2).reshape(
            tuple(t.shape[:-1]) + (n * t.shape[-1],)))
        off += t.numel()
    return out


def _norm_dot_sum(s, mesh):
    """The gated norm's backward collective: each row's term ``s_loc``
    (f32) summed over the model ranks, in place (counted as
    ``tp_norm_dot``)."""
    _count(tp_norm_dot, s)
    return mesh.all_reduce(s, "model")


def tp_norm_dot():
    """Holds the counters of the gated norm's backward collective
    (:func:`_norm_dot_sum`): ``tp_norm_dot.calls`` / ``.bytes``."""


for _op in (tp_all_reduce, tp_all_gather, tp_enter, tp_norm_dot):
    _op.calls, _op.bytes = LaunchCounter(), LaunchCounter()


def gated_rms_norm(x, z, w, eps=1e-5, width=None):
    """Mamba2-style norm: ``rms_norm(x * silu(z))``, the gate in f32.
    ``width`` (tensor parallelism): the whole row's width when x holds
    only this rank's columns of it; the f32 sum of squares of the local
    columns is all-reduced and the kernel applies the row's statistic
    (``rms_norm_rstd``), since a per-rank statistic would be wrong.  Under
    autograd the statistic's gradient path is the norm's own backward,
    whose row terms are all-reduced (:func:`_norm_dot_sum`, looked up at
    each call)."""
    g = x * F.silu(z.float()).to(x.dtype)
    if width is None or width == x.shape[-1]:
        return rms_norm(g, w, eps)
    ss = tp_all_reduce(g.detach().float().square().sum(dim=-1))
    return rms_norm_rstd(g, w, torch.rsqrt(ss / width + eps), width=width,
                         reduce=functools.partial(_norm_dot_sum,
                                                  mesh=current_mesh()))


# --------------------------------------------------------- cache invariance
def tree_map(fn, tree, *rest, is_leaf=None):
    """Map ``fn`` over the leaves of a dict/tuple tree (and of ``rest``,
    trees of the same structure, leaf for leaf)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(t[k] for t in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(t[i] for t in rest), is_leaf=is_leaf)
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


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


def page_scatter_window(pool, table, page_size, pos, update, n_tok):
    """Write a per-slot window of tokens into the paged pool, in place (the
    speculative-decode verify append).

    pos: (B,) first logical position per slot; update: (B, S, ...) the
    window's values; n_tok: (B,) valid lanes per slot (0: a dead slot).
    Lane j of slot b lands at logical position ``pos_b + j`` when ``j <
    n_tok_b``; masked lanes (padding past a short draft, every lane of a
    dead slot) go to garbage page 0, offset 0, as the reference sends
    them, so a padded write never touches a live page.  Valid lanes of
    distinct slots never collide: each slot owns its pages."""
    b, s = update.shape[:2]
    lane = torch.arange(s, device=pool.device)
    idx = pos.long()[:, None] + lane                          # (B, S)
    valid = lane[None, :] < n_tok.long()[:, None]
    # the clamp keeps a masked lane's lookup inside the table; valid lanes
    # are covered (the engine grows or reserves pages through pos + n_tok)
    lp = (idx // page_size).clamp(0, table.shape[1] - 1)
    page = torch.where(valid, torch.gather(table.long(), 1, lp), 0)
    off = torch.where(valid, idx % page_size, 0)
    pool[page, off] = update.to(pool.dtype)
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


def sinusoidal_pos(pos, dim: int, device=None):
    """(...,) positions -> (..., dim) classic transformer sinusoidal
    embedding in f32 (the caller casts): sines of the first half of the
    frequencies, then cosines."""
    half = dim // 2
    pos = torch.as_tensor(pos, device=device)
    freqs = torch.exp(-np.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=pos.device) / half)
    ang = pos.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------------- MLP
def mlp_dense(x, p, cfg):
    """SwiGLU MLP. x: (B, S, D); weights cast to x's dtype per use.  Under
    tensor parallelism the weights are this rank's d_ff shard, x enters
    them (:func:`tp_enter`) and the partial products are all-reduced."""
    dt = x.dtype
    split = tp_shards(cfg.d_ff, "tp") > 1
    if split:
        x = tp_enter(x)
    h = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    out = (F.silu(h) * u) @ p["w_down"].to(dt)
    return tp_all_reduce(out) if split else out


def embed_tokens(tokens, p_embed, cfg, dtype):
    """tokens: (B, S) int -> (B, S, D); audio codebooks: (B, S, K) ->
    the sum over k of codebook k's embedding of ``tokens[..., k]``, in
    ``dtype`` and in the reference's order (MusicGen-style)."""
    tokens = tokens.long()
    emb = p_embed["tok"].to(dtype)                  # (V, D) | (K, V, D)
    n = tp_shards(cfg.vocab, "vocab")
    if n > 1:
        # vocab-parallel: this rank's rows, zeros for ids it does not
        # hold; every id has exactly one owner, so the all-reduce's sum is
        # the row itself, bit for bit (codebooks reduced apart, summed after)
        rows = cfg.vocab // n
        loc = tokens - tp_coord("vocab") * rows
        own = (loc >= 0) & (loc < rows)
        loc = loc.clamp(0, rows - 1)
        if cfg.frontend == "audio_codebooks":
            parts = torch.stack([
                torch.where(own[..., k, None], emb[k][loc[..., k]], 0)
                for k in range(cfg.n_codebooks)])
            parts = tp_all_reduce(parts)
            out = parts[0]
            for k in range(1, cfg.n_codebooks):
                out = out + parts[k]
            return out
        return tp_all_reduce(torch.where(own[..., None], emb[loc], 0))
    if cfg.frontend == "audio_codebooks":               # emb: (K, V, D)
        out = emb[0][tokens[..., 0]]
        for k in range(1, cfg.n_codebooks):
            out = out + emb[k][tokens[..., k]]
        return out
    return emb[tokens]


def lm_logits(x, params, cfg):
    """x: (B, S, D) -> (B, S, V); audio codebooks: (B, S, K, V), head k
    from ``lm_head[k]`` (K, D, V).  Vocab-split under tensor parallelism:
    x enters the local columns (:func:`tp_enter`), the logits are
    gathered whole."""
    dt = x.dtype
    split = tp_shards(cfg.vocab, "vocab") > 1
    if split:
        x = tp_enter(x)
    if cfg.frontend == "audio_codebooks":
        out = torch.einsum("bsd,kdv->bskv", x, params["lm_head"].to(dt))
    else:
        if cfg.tie_embeddings:
            w = params["embed"]["tok"].to(dt).T           # (D, V)
        else:
            w = params["lm_head"].to(dt)                  # (D, V)
        out = x @ w
    # column-parallel: this rank's vocab columns, gathered whole
    return tp_all_gather(out) if split else out


def softmax_xent(logits, labels, z_loss=0.0):
    """Per-token cross entropy in f32 with the z-loss folded in: ``lse -
    gold + z_loss * lse^2``.  labels: int ids; a negative (masked) label
    gathers column 0 and its loss is the caller's to mask."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long().clamp_min(0)[..., None])[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss
