"""The reference's serve-step bars (``tests/test_serve_steps.py``) held
inside the port, on the CPU with the kernels' plain versions: paged
decode gives the dense decode's tokens, any slot schedule gives the
one-shot tokens, page_size 1 works, and the insert/decode steps keep
every cache leaf's shape and dtype (the in-place update contract)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.models.layers import tree_leaves
from repro_torch.models.lm import init_params
from repro_torch.serve import PagePool
from repro_torch.steps import (greedy_oneshot, init_paged_slot_cache,
                               init_slot_cache, make_batched_insert_step,
                               make_decode_step, make_prefill_step,
                               make_serve_step)

SLOTS, PLEN, GEN = 3, 8, 4
CACHE_LEN = PLEN + GEN


@pytest.fixture(scope="module")
def built():
    cfg = get("qwen2.5-14b").tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (SLOTS, PLEN)).astype(np.int32))
    prefill = make_prefill_step(cfg, cache_len=CACHE_LEN)
    ref = greedy_oneshot(prefill, make_serve_step(cfg), params, prompts,
                         None, GEN).numpy()
    return dict(cfg=cfg, params=params, prompts=prompts, prefill=prefill,
                ref=ref)


def _shapes(cache):
    return [(tuple(x.shape), x.dtype) for x in tree_leaves(cache)]


def _run_schedule(b, seed, page_size, paged_kernel=False, n_req=6,
                  pool_pages=None):
    """Seeded schedule: requests (prompt rows reused mod SLOTS, fuzzed
    budgets) arrive in random order into random free slots, decode ticks
    interleave with inserts; paged pools are deliberately tight so
    admission blocks, and pages are freed the tick a request ends."""
    cfg, params = b["cfg"], b["params"]
    rng = np.random.default_rng(seed)
    rows, logits = b["prefill"](params, b["prompts"])
    t0 = logits.argmax(-1).int()
    paged = page_size is not None
    dt = torch.float32
    if paged:
        pps = CACHE_LEN // page_size
        pool_pages = pool_pages or 2 * pps + 2
        pager = PagePool(pool_pages, page_size)
        cache = init_paged_slot_cache(cfg, SLOTS, CACHE_LEN, dt, page_size,
                                      pool_pages, "cpu")
        table = np.zeros((SLOTS, pps), np.int32)
    else:
        cache = init_slot_cache(cfg, SLOTS, CACHE_LEN, dt, "cpu")
    shapes0 = _shapes(cache)
    insert = make_batched_insert_step(cfg, cache_len=CACHE_LEN,
                                      page_size=page_size)
    decode = make_decode_step(cfg, cache_len=CACHE_LEN, page_size=page_size,
                              paged_kernel=paged_kernel)
    toks = torch.zeros((SLOTS, 1), dtype=torch.int32)
    active = np.zeros((SLOTS,), bool)
    gens = rng.integers(1, GEN + 1, n_req)
    waiting = list(rng.permutation(n_req))
    live, outs, pages_of = {}, {}, {}
    blocked = 0

    def free_slot(i, s):
        active[s] = False
        del live[s]
        if paged:
            table[s, :] = 0
            pager.free(pages_of.pop(i))

    for _ in range(10_000):
        if not waiting and not live:
            break
        free = np.flatnonzero(~active)
        did_insert = False
        if waiting and len(free) and (not live or rng.random() < 0.5):
            i = int(waiting[0])
            ids = pager.reserve(PLEN + int(gens[i]) - 1) if paged else []
            if ids is None:
                blocked += 1            # admission blocks; tick instead
            else:
                waiting.pop(0)
                s = int(rng.choice(free))
                if paged:
                    pages_of[i] = ids
                    table[s, :] = 0
                    table[s, :len(ids)] = ids
                    cache = insert(cache, rows, i % SLOTS, s,
                                   torch.tensor(table[s]))
                else:
                    cache = insert(cache, rows, i % SLOTS, s)
                assert _shapes(cache) == shapes0
                toks = toks.clone()
                toks[s] = t0[i % SLOTS]
                outs[i] = [int(t0[i % SLOTS, 0])]
                active[s] = True
                live[s] = i
                did_insert = True
                if len(outs[i]) >= gens[i]:
                    free_slot(i, s)
        if live and not did_insert:
            args = (params, cache, toks, torch.tensor(active))
            if paged:
                args += (torch.tensor(table),)
            toks, cache = decode(*args)
            assert _shapes(cache) == shapes0
            for s, i in list(live.items()):
                outs[i].append(int(toks[s, 0]))
                if len(outs[i]) >= gens[i]:
                    free_slot(i, s)
    assert not waiting and not live, "schedule deadlocked"
    if paged:
        assert pager.used_pages == 0, "pages leaked"
    for i in range(n_req):
        assert outs[i] == list(b["ref"][i % SLOTS, :gens[i]]), (
            f"req {i} (gen {gens[i]}, seed {seed}, page_size {page_size})")
    return blocked


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("page_size,paged_kernel",
                         [(None, False), (4, False), (4, True), (1, True)])
def test_schedule_matches_oneshot(built, seed, page_size, paged_kernel):
    _run_schedule(built, seed, page_size, paged_kernel)


def test_pool_for_one_request_blocks_but_never_corrupts(built):
    """Room for exactly one worst-case request (3 pages of 4 + garbage):
    admissions block until a completion frees pages; tokens stay exact."""
    assert _run_schedule(built, 0, 4, True, pool_pages=4) > 0


def test_paged_decode_matches_dense_decode(built):
    """All slots live from the start: the paged-kernel leg, the
    paged-gather leg and the dense leg emit the same tokens every tick."""
    cfg, params = built["cfg"], built["params"]
    rows, logits = built["prefill"](params, built["prompts"])
    t0 = logits.argmax(-1).int()
    caches, steps, tables = {}, {}, {}
    for name, ps, pk in (("dense", None, False), ("gather", 2, False),
                         ("kernel", 2, True)):
        steps[name] = make_decode_step(cfg, cache_len=CACHE_LEN,
                                       page_size=ps, paged_kernel=pk)
        insert = make_batched_insert_step(cfg, cache_len=CACHE_LEN,
                                          page_size=ps)
        if ps is None:
            c = init_slot_cache(cfg, SLOTS, CACHE_LEN, torch.float32, "cpu")
            for s in range(SLOTS):
                c = insert(c, rows, s, s)
        else:
            pps = CACHE_LEN // ps
            c = init_paged_slot_cache(cfg, SLOTS, CACHE_LEN, torch.float32,
                                      ps, 1 + SLOTS * pps, "cpu")
            tables[name] = torch.arange(1, 1 + SLOTS * pps,
                                        dtype=torch.int32).view(SLOTS, pps)
            tables[name] = tables[name].flip(0).contiguous()
            for s in range(SLOTS):
                c = insert(c, rows, s, s, tables[name][s])
        caches[name] = c
    active = torch.ones(SLOTS, dtype=torch.bool)
    toks = {k: t0 for k in caches}
    for _ in range(GEN - 1):
        for k in caches:
            extra = (tables[k],) if k in tables else ()
            toks[k], caches[k] = steps[k](params, caches[k], toks[k],
                                          active, *extra)
        assert torch.equal(toks["dense"], toks["gather"])
        assert torch.equal(toks["dense"], toks["kernel"])


def test_masked_decode_freezes_dead_slot_pos(built):
    cfg, params = built["cfg"], built["params"]
    rows, logits = built["prefill"](params, built["prompts"])
    cache = init_slot_cache(cfg, SLOTS, CACHE_LEN, torch.float32, "cpu")
    cache = make_batched_insert_step(cfg, cache_len=CACHE_LEN)(
        cache, rows, 0, 2)
    toks = torch.zeros((SLOTS, 1), dtype=torch.int32)
    toks[2] = logits.argmax(-1).int()[0]
    active = torch.tensor([False, False, True])
    pos0 = cache["pos"].clone()
    toks, cache = make_decode_step(cfg)(params, cache, toks, active)
    assert cache["pos"][2] == pos0[2] + 1
    assert cache["pos"][0] == pos0[0] and cache["pos"][1] == pos0[1]
    assert int(toks[0, 0]) == 0 and int(toks[1, 0]) == 0


def test_step_argument_checks(built):
    cfg = built["cfg"]
    with pytest.raises(ValueError, match="page_size"):
        make_decode_step(cfg, paged_kernel=True)
    with pytest.raises(ValueError, match="divide"):
        init_paged_slot_cache(cfg, 2, 10, torch.float32, 4, 8, "cpu")
