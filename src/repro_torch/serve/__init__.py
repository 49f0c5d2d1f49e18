"""``repro_torch.serve`` — the continuous-batching serve engine on the UMT
runtime, ported to PyTorch (main path: reserve policy, paged or dense KV
pool, paged-decode kernel).  ``pager``, ``policy`` and ``request`` are
copies of the reference's JAX-free modules.

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
"""
from .engine import ServeEngine, auto_page_size
from .kvstate import KVState
from .pager import GARBAGE_PAGE, PagePool
from .policy import POLICIES, SchedulerPolicy, SlotView, make_policy
from .request import Request, RequestQueue

__all__ = ["ServeEngine", "Request", "RequestQueue", "KVState", "PagePool",
           "GARBAGE_PAGE", "auto_page_size", "SchedulerPolicy", "SlotView",
           "make_policy", "POLICIES"]
