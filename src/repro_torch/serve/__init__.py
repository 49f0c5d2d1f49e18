"""``repro_torch.serve`` — the continuous-batching serve engine on the UMT
runtime, ported to PyTorch: paged or dense KV pool, paged-decode kernel,
chunked prefill, the shared-prefix cache, and the reserve and on-demand
(eviction and restore) policies.  ``pager``, ``policy``, ``prefix`` and
``request`` are copies of the reference's JAX-free modules;
:func:`drain` waits for an engine's requests under a deadline.

Usage::

    import torch
    from repro_torch.configs import get
    from repro_torch.models.lm import init_params
    from repro_torch.serve import Request, ServeEngine

    cfg = get("qwen2.5-14b").tiny()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    with ServeEngine(cfg, params, slots=4, cache_len=48,
                     paged_kernel=True) as eng:
        for i, prompt in enumerate(prompts):      # (P,) int32 arrays
            eng.submit(Request(i, prompt, max_new_tokens=16))
        eng.close()
        eng.join()
    print(eng.stats())

    # or, failing loudly (stats + every thread's stack) past a deadline:
    eng = ServeEngine(cfg, params, slots=4, cache_len=48).start()
    reqs = [Request(i, p, max_new_tokens=16) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    stats = drain(eng, reqs, timeout_s=120)
"""
from .engine import PORT_ONLY_STATS, ServeEngine, auto_page_size
from .kvstate import KVState
from .pager import GARBAGE_PAGE, PagePool
from .policy import (POLICIES, OnDemandPolicy, SchedulerPolicy, SlotView,
                     make_policy)
from .request import Request, RequestQueue
from .watchdog import drain

__all__ = ["ServeEngine", "Request", "RequestQueue", "KVState", "PagePool",
           "GARBAGE_PAGE", "auto_page_size", "SchedulerPolicy",
           "OnDemandPolicy", "SlotView", "make_policy", "POLICIES",
           "PORT_ONLY_STATS", "drain"]
