"""Serving steps (PyTorch port of the serving subset of
``repro/steps.py``).

The reference jits each step and donates the cache argument so XLA
aliases it in place.  Here the steps run eagerly and update the pool in
place themselves, under the same contract: every cache leaf keeps its
shape and dtype (``models.layers.check_cache_invariant``), so the caller
simply rebinds the returned cache.  Train and verify steps belong to
later slices.
"""
from __future__ import annotations

import torch

from .models.layers import tree_map
from .models.lm import cache_meta, forward, init_cache


def cast_tree(tree, dtype):
    """Floating leaves to ``dtype`` (a no-op for weights already stored in
    it, as on the card)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return tree_map(lambda x: x.to(dt) if x.is_floating_point() else x,
                    tree)


def make_prefill_step(cfg, cache_len=None):
    """(params, tokens, patches=None) -> (row cache, last logits)."""

    def prefill_step(params, tokens, patches=None):
        if patches is not None:
            raise NotImplementedError(
                "vision patches are not ported yet (ROADMAP.md queue 1, "
                "item 7)")
        out = forward(cast_tree(params, cfg.dtype), cfg, tokens,
                      mode="prefill", cache_len=cache_len)
        return out["cache"], out["logits"]

    return prefill_step


def make_serve_step(cfg):
    """One decode step at the cache's scalar ``pos``:
    (params, cache, tokens) -> (next_tokens, cache)."""

    def serve_step(params, cache, tokens):
        out = forward(cast_tree(params, cfg.dtype), cfg, tokens,
                      mode="decode", pos=cache["pos"], cache=cache)
        return out["logits"].argmax(dim=-1).int(), out["cache"]

    return serve_step


def greedy_oneshot(prefill, serve_step, params, prompts, patches, gen):
    """Batched prefill, then ``gen - 1`` decode ticks; (B, gen) tokens —
    the reference the engine's tokens are held to."""
    cache, logits = prefill(params, prompts, patches)
    tok = logits.argmax(dim=-1).int()
    out = [tok]
    for _ in range(gen - 1):
        tok, cache = serve_step(params, cache, tok)
        out.append(tok)
    return torch.cat(out, dim=1)


# ------------------------------------------------- continuous-batching steps
def init_slot_cache(cfg, slots: int, cache_len: int, dtype, device="cuda"):
    """Batched cache for ``slots`` serve slots with a (slots,) ``pos``."""
    cache = init_cache(cfg, slots, cache_len, dtype, device)
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


def init_paged_slot_cache(cfg, slots: int, cache_len: int, dtype,
                          page_size: int, num_pages: int, device="cuda"):
    """Slot cache whose linear attention leaves are paged pools of shape
    (n_repeats, num_pages, page_size, *tail).  Page 0 is the garbage
    page: dead slots and unallocated logical pages point there."""
    if cache_len % page_size:
        raise ValueError(f"page_size {page_size} must divide cache_len "
                         f"{cache_len}")
    if num_pages < 2:
        raise ValueError("need at least one usable page + garbage page 0")
    meta = cache_meta(cfg, slots, cache_len)
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


def make_batched_insert_step(cfg, *, cache_len: int,
                             page_size: int | None = None):
    """Insert row ``row`` of a batched prefill cache into slot ``slot`` of
    the shared cache, in place.

    Dense: (cache, rows_cache, row, slot) -> cache.
    Paged: (cache, rows_cache, row, slot, table_row) -> cache, where
    ``table_row`` holds the slot's physical page ids; unreserved logical
    pages point at garbage page 0, where their writes collide (which one
    lands is unspecified — page 0 is never read at a valid position)."""

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


def make_prefix_gather_step(cfg, *, cache_len: int, page_size: int):
    """The read half of a prefix-cache hit: a fresh batch-1 dense row
    cache gathered from shared KV pages,

        (cache, table_row, pos) -> row_cache

    ``table_row`` is a (pages_per_slot,) physical page vector whose
    leading entries are the matched prefix pages (plus the copy-on-write
    fork source) and whose tail points at garbage page 0; ``pos`` (a host
    int) is the number of valid prefix tokens.  Positions past ``pos``
    hold garbage-page content, which the tail's chunks overwrite or the
    position mask excludes.  A pure read of the pool: the caller enqueues
    it before any later step that writes those pages."""
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


def make_prefill_chunk_step(cfg, cache_len: int | None = None):
    """Cache-append prefill continuation (chunked prefill):

        (params, row_cache, tokens, q_off) -> (row_cache, last logits)

    ``row_cache`` is a dense (B, cache_len) cache (start from
    ``init_cache``), updated in place; ``tokens`` is the (B, C) chunk
    written at positions ``[q_off, q_off + C)`` (``q_off`` a host int).
    Keywords ``attn_extent`` (the key extent each chunk attends over) and
    ``want_logits`` (False: a non-final chunk skips the LM head, and the
    logits come back None).  The last chunk's logits equal the one-shot
    prefill's within rounding; MoE, SSM and sliding-window rings shorter
    than ``cache_len`` cannot chunk exactly (:func:`chunkable`)."""
    assert cache_len is not None
    assert chunkable(cfg, cache_len), (
        f"{cfg.name}: chunked prefill needs linear-cache attention blocks "
        "(no MoE, no SSM, no SWA ring shorter than cache_len)")

    def chunk_step(params, row_cache, tokens, q_off, patches=None, *,
                   attn_extent=None, want_logits=True):
        if patches is not None:
            raise NotImplementedError(
                "vision patches are not ported yet (ROADMAP.md queue 1, "
                "item 7)")
        out = forward(cast_tree(params, cfg.dtype), cfg, tokens,
                      mode="prefill_chunk", pos=int(q_off), cache=row_cache,
                      cache_len=cache_len, attn_extent=attn_extent,
                      want_logits=want_logits)
        return out["cache"], out["logits"]

    return chunk_step


def make_decode_step(cfg, *, cache_len: int | None = None,
                     page_size: int | None = None,
                     paged_kernel: bool = False):
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

    def decode_step(params, cache, tokens, active, table=None):
        pages = ({"table": table, "page_size": page_size,
                  "cache_len": cache_len, "kernel": paged_kernel}
                 if paged else None)
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


__all__ = ["cast_tree", "make_prefill_step", "make_serve_step",
           "greedy_oneshot", "init_slot_cache", "init_paged_slot_cache",
           "paged_names", "chunkable", "make_batched_insert_step",
           "make_prefix_gather_step", "make_prefill_chunk_step",
           "make_decode_step", "init_cache"]
