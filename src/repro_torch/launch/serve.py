"""Serving driver — thin CLI over the port's continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --paged-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --device cpu \
        --arch minicpm3-4b --paged-kernel

``--arch`` picks a config of the registry whose families the port
serves: GQA (qwen2.5-14b, the default), MLA (minicpm3-4b), SSD
(mamba2-780m) and MoE with sliding-window attention (mixtral-8x7b).

The flags and the one JSON line (same keys) of ``repro.launch.serve``,
plus ``--device {cuda,cpu}`` (default ``cuda``; ``cuda`` without a card
raises).  ``--mode oneshot`` runs the one-shot batch path; ``--chunk N``
prefills prompts longer than N in chunks of N tokens, and
``--prefix-cache {auto,on,off}`` sets shared-prefix KV reuse (auto: on
for a paged engine on a chunk-exact config), as in the reference.
Options whose engine features belong to later slices (``--spec``,
``--policy ondemand``, ``--mesh``) raise ``NotImplementedError``.
Weights are a seeded ``torch.Generator`` init on the device (seed 0);
prompts are drawn with numpy from ``--seed``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get
from ..device import resolve_device
from ..models.lm import init_params
from ..steps import make_prefill_step, make_serve_step


def _prompts(cfg, n, prompt_len, seed=1):
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} frontend is not ported yet "
            "(ROADMAP.md queue 1, item 7)")
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (n, prompt_len)).astype(np.int32)


def serve_oneshot(cfg, params, device, args):
    """Prefill one batch, decode greedily to the end."""
    cache_len = args.prompt_len + args.gen
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    decode = make_serve_step(cfg)
    prompts = torch.tensor(_prompts(cfg, args.batch, args.prompt_len,
                                    args.seed), device=device)
    t0 = time.time()
    cache, last_logits = prefill(params, prompts)
    tok = last_logits.argmax(dim=-1).int()
    tok.cpu()
    t_prefill = time.time() - t0
    out = [tok]
    t0 = time.time()
    for _ in range(args.gen - 1):
        tok, cache = decode(params, cache, tok)
        out.append(tok)
    gen = torch.cat(out, dim=1).cpu()
    t_decode = time.time() - t0
    print(json.dumps({
        "mode": "oneshot",
        "arch": cfg.name,
        "prefill_s": round(t_prefill, 3),
        "decode_s_per_tok": round(t_decode / max(args.gen - 1, 1), 4),
        "generated_shape": list(gen.shape),
        "sample": [int(x) for x in gen.reshape(-1)[:8]],
    }))
    return gen


def serve_engine(cfg, params, device, args):
    """Continuous batching: a slot pool fed by a monitored request queue."""
    from ..serve import Request, ServeEngine

    cache_len = args.prompt_len + args.gen
    prompts = _prompts(cfg, args.requests, args.prompt_len, args.seed)
    page_size = ("auto" if args.page_size == 0
                 else None if args.page_size < 0 else args.page_size)
    t0 = time.time()
    with ServeEngine(cfg, params, slots=args.batch, cache_len=cache_len,
                     mesh=args.mesh, umt=not args.no_umt,
                     n_cores=args.cores, page_size=page_size,
                     num_pages=args.pages if args.pages > 0 else None,
                     prefill_chunk=args.chunk if args.chunk > 0 else None,
                     donate=not args.no_donate,
                     paged_kernel=args.paged_kernel, policy=args.policy,
                     prefix_cache=args.prefix_cache,
                     spec=None if args.spec == "off" else args.spec,
                     spec_k=args.spec_k, device=device) as eng:
        reqs = []
        for i in range(args.requests):
            reqs.append(Request(i, prompts[i], max_new_tokens=args.gen))
            eng.submit(reqs[-1])
            if args.arrival_ms:
                time.sleep(args.arrival_ms / 1e3)
        eng.close()
        eng.join()
        stats = eng.stats()
    wall = time.time() - t0
    for r in reqs:
        r.wait()                        # re-raises an engine-side failure
    gen = np.stack([np.asarray(r.out_tokens, np.int32) for r in reqs])
    print(json.dumps({
        "mode": "engine",
        "arch": cfg.name,
        "umt": not args.no_umt,
        "page_size": stats["page_size"],
        "tp": stats["tp"],
        "donate": stats["donate"],
        "paged_kernel": stats["paged_kernel"],
        "policy": stats["policy"],
        "kv_versions": stats["kv_version"],
        "pages_used_peak": stats.get("pages_used_peak"),
        "pages_grown": stats["pages_grown"],
        "admission_blocks": stats["admission_blocks"],
        "evictions": stats["evictions"],
        "restores": stats["restores"],
        "prefix_cache": stats["prefix_cache"],
        "prefix_hits": stats["prefix_hits"],
        "prefix_tokens_saved": stats["prefix_tokens_saved"],
        "cow_forks": stats["cow_forks"],
        "shared_pages": stats.get("shared_pages"),
        "pages_cached": stats.get("pages_cached"),
        "prefill_calls": stats["prefill_calls"],
        "prefill_chunks": stats["prefill_chunks"],
        "spec": stats["spec"],
        "spec_drafted": stats["spec_drafted"],
        "spec_accepted": stats["spec_accepted"],
        "spec_rollbacks": stats["spec_rollbacks"],
        "spec_accept_rate": round(stats["spec_accept_rate"], 3),
        "decode_dispatches": stats["decode_dispatches"],
        "dispatches_per_token": round(stats["dispatches_per_token"], 4),
        "wall_s": round(wall, 3),
        "tokens_s": round(stats["tokens_out"] / wall, 1),
        "occupancy": round(stats["occupancy"], 3),
        "p50_latency_s": round(stats["p50_latency_s"], 4),
        "p99_latency_s": round(stats["p99_latency_s"], 4),
        "generated_shape": list(gen.shape),
        "sample": [int(x) for x in gen.reshape(-1)[:8]],
    }))
    return gen


def serve(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=1,
                    help="prompt seed (numpy)")
    ap.add_argument("--mode", choices=("engine", "oneshot"),
                    default="engine")
    ap.add_argument("--batch", type=int, default=4,
                    help="slot-pool size (engine) / batch size (oneshot)")
    ap.add_argument("--requests", type=int, default=0,
                    help="engine: total requests to serve (default: batch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--arrival-ms", type=float, default=0.0,
                    help="engine: gap between request arrivals")
    ap.add_argument("--no-umt", action="store_true",
                    help="engine: baseline runtime (blocked = idle core)")
    ap.add_argument("--cores", type=int, default=None,
                    help="engine: runtime core count")
    ap.add_argument("--page-size", type=int, default=0,
                    help="engine: KV page size (0 = auto, <0 = dense "
                         "per-slot cache, no paging)")
    ap.add_argument("--pages", type=int, default=0,
                    help="engine: KV page-pool size incl. garbage page "
                         "(0 = dense-equivalent capacity)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="engine: chunked prefill of prompts longer than "
                         "this many tokens (0 = one-shot prefill)")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="engine: decode attention through the paged-decode "
                         "CUDA kernel (reads KV pages in place)")
    ap.add_argument("--no-donate", action="store_true",
                    help="engine: accepted for parity; the pool is always "
                         "updated in place")
    ap.add_argument("--policy", choices=("reserve", "ondemand"),
                    default="reserve",
                    help="engine: scheduler policy (ondemand not ported yet)")
    ap.add_argument("--spec", choices=("off", "ngram"), default="off",
                    help="engine: speculative decoding (not ported yet)")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="tensor-parallel mesh (not ported yet)")
    ap.add_argument("--prefix-cache", choices=("auto", "on", "off"),
                    default="auto",
                    help="engine: shared-prefix KV reuse (auto = on for "
                         "a paged engine on a chunk-exact config)")
    args = ap.parse_args(argv)
    if args.requests <= 0:
        args.requests = args.batch

    device = resolve_device(args.device)
    cfg = get(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    if args.mode == "oneshot":
        return serve_oneshot(cfg, params, device, args)
    return serve_engine(cfg, params, device, args)


if __name__ == "__main__":
    serve()
