"""The shared-prefix (radix) KV cache in the port: the trie (a copy of
``repro/serve/prefix.py``), the gather step, the insert row that masks
shared pages, and the engine's hit path (gather + tail chunks + COW fork
+ shared-page admission) against the reference engine.

CPU, f32, the tiny configs of qwen2.5-14b (GQA) and minicpm3-4b (MLA),
and of the two frontends: musicgen-large's (P, K) codebook prompts hit
as text prompts do, and an internvl2-2b request never looks up or enters
the trie (its token key lacks its patches); weights from the
reference's ``init_params`` through ``repro_torch.params``.  Every
request shares its first ``N_SHARED`` positions with request 0 (a
system prompt), which is served to completion first so its pages are in
the trie when the rest arrive.  Tokens are
held exactly: to the port's one-shot tokens (the cold leg) and to the
reference engine's; the prefix and chunk counters equal the reference
engine's.  Every engine drains under a deadline
(``repro_torch.serve.drain``).
"""
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get
from repro.models.lm import init_params as jax_init_params
from repro_torch.params import params_from_numpy
from repro_torch.serve import PORT_ONLY_STATS, Request, ServeEngine, drain
from repro_torch.serve.watchdog import abandon
from repro_torch.steps import (greedy_oneshot, make_prefill_step,
                               make_serve_step)
from test_torch_engine import frontend_inputs, oneshot

N_REQ, PLEN, GEN, N_SHARED, PS = 6, 12, 4, 9, 4
CACHE_LEN = PLEN + GEN
TIMEOUT_S = 120
COUNTERS = ("prefix_hits", "prefix_tokens_saved", "cow_forks",
            "prefill_chunks", "prefill_chunk_tasks", "prefill_calls",
            "prefix_cache")


@pytest.fixture(scope="module", params=["qwen2.5-14b", "minicpm3-4b"])
def built(request):
    cfg = get(request.param).tiny()
    jp = jax_init_params(cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (N_REQ, PLEN)).astype(np.int32)
    prompts[1:, :N_SHARED] = prompts[0, :N_SHARED]
    ref = greedy_oneshot(make_prefill_step(cfg, cache_len=CACHE_LEN),
                         make_serve_step(cfg), params,
                         torch.tensor(prompts), None, GEN).numpy()
    return dict(cfg=cfg, jp=jp, params=params, prompts=prompts, ref=ref)


def _serve(eng, reqs, gaps=0.0):
    """Request 0 to completion first (its pages warm the trie), then the
    rest; the deadline covers both waits."""
    eng.start()
    eng.submit(reqs[0])
    if not reqs[0].done.wait(TIMEOUT_S):
        abandon(eng, f"request 0 not done after {TIMEOUT_S} s")
    for r in reqs[1:]:
        eng.submit(r)
        time.sleep(gaps)
    return drain(eng, reqs, TIMEOUT_S), eng.pager


def _requests(b, cls=Request):
    pt = b.get("patches")
    return [cls(i, b["prompts"][i], max_new_tokens=GEN,
                patches=None if pt is None else pt[i])
            for i in range(N_REQ)]


def _port(b, rt=None, **kw):
    reqs = _requests(b)
    eng = ServeEngine(b["cfg"], b["params"], slots=3, cache_len=CACHE_LEN,
                      n_cores=4, rt=rt, page_size=PS, paged_kernel=True,
                      device="cpu", **kw)
    stats, pager = _serve(eng, reqs, 0.002)
    return [np.asarray(r.wait(), np.int32) for r in reqs], stats, pager


def _reference(b, **kw):
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine

    reqs = _requests(b, JRequest)
    eng = JServeEngine(b["cfg"], b["jp"], slots=3, cache_len=CACHE_LEN,
                       n_cores=4, page_size=PS, paged_kernel=True, **kw)
    stats, _ = _serve(eng, reqs, 0.002)
    return [np.asarray(r.wait(), np.int32) for r in reqs], stats


@pytest.mark.parametrize("chunk", [None, 5])
def test_prefix_hit_equals_cold_leg_and_reference_engine(built, chunk):
    """Hits gather 2 full pages + a 1-token fork (9 shared tokens at page
    size 4) and chunk-prefill the 3-token tail; with ``prefill_chunk=5``
    request 0 is chunked too.  Tokens equal the cold one-shot tokens
    and the reference engine's; the counters equal the reference's; no
    page leaks (held pages: none; used pages: only the trie's)."""
    toks, stats, pager = _port(built, prefix_cache="on", prefill_chunk=chunk)
    jtoks, jstats = _reference(built, prefix_cache="on",
                               prefill_chunk=chunk)
    for i in range(N_REQ):
        assert np.array_equal(toks[i], built["ref"][i]), f"request {i}"
        assert np.array_equal(toks[i], jtoks[i]), f"request {i}"
    assert stats["prefix_hits"] == N_REQ - 1
    assert stats["prefix_tokens_saved"] == (N_REQ - 1) * N_SHARED
    assert stats["cow_forks"] == N_REQ - 1
    assert {k: stats[k] for k in COUNTERS} == {k: jstats[k]
                                                for k in COUNTERS}
    assert set(stats) - set(PORT_ONLY_STATS) == set(jstats)
    assert pager.live_refs == 0
    assert pager.used_pages == pager.cached_pages > 0


@pytest.fixture(scope="module", params=["internvl2-2b", "musicgen-large"])
def frontend(request):
    """Requests sharing their first ``N_SHARED`` positions with request 0:
    the same patches and 5 text tokens for vision, 9 (K,) code vectors
    for audio."""
    cfg = get(request.param).tiny()
    jp = jax_init_params(cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    prompts, patches = frontend_inputs(cfg, N_REQ, PLEN)
    n_text = N_SHARED
    if patches is not None:
        patches[1:] = patches[0]
        n_text -= cfg.n_patches
    prompts[1:, :n_text] = prompts[0, :n_text]
    ref = oneshot(cfg, params, prompts, patches, GEN, CACHE_LEN)
    return dict(cfg=cfg, jp=jp, params=params, prompts=prompts,
                patches=patches, ref=ref)


@pytest.mark.parametrize("chunk", [None, 5])
def test_frontends_on_the_prefix_path(frontend, chunk):
    """Audio: the hits gather request 0's pages and chunk their tails, and
    the tokens are the cold one-shot tokens.  Vision: the same patches and
    shared text still never look up or enter the trie, every prompt is
    prefilled cold with its patches (on the first chunk when chunked).
    Tokens and counters equal the reference engine's: for vision the
    prefix counters only, since its cold requests coalesce into prefill
    rounds as they happen to arrive (a hit always takes a chain of its
    own), so its prefill and chunk counts vary from run to run."""
    b = frontend
    toks, stats, pager = _port(b, prefix_cache="on", prefill_chunk=chunk)
    jtoks, jstats = _reference(b, prefix_cache="on", prefill_chunk=chunk)
    for i in range(N_REQ):
        assert np.array_equal(toks[i], b["ref"][i]), f"request {i}"
        assert np.array_equal(toks[i], jtoks[i]), f"request {i}"
    keys = COUNTERS if b["patches"] is None else (
        "prefix_hits", "prefix_tokens_saved", "cow_forks", "prefix_cache")
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert stats["prefill_reqs"] == N_REQ
    if b["patches"] is not None:
        assert stats["prefix_hits"] == 0
        assert stats["prefix_lookups"] == 0 == stats["prefix_inserted_pages"]
        assert pager.used_pages == 0
    else:
        assert stats["prefix_hits"] == N_REQ - 1
        assert stats["prefix_tokens_saved"] == (N_REQ - 1) * N_SHARED
    assert pager.live_refs == 0


def test_auto_resolves_as_the_reference_and_off_misses(built):
    """"auto" is on for a paged engine on a chunk-exact config; "off"
    serves the same tokens with no hit."""
    _, on, _ = _port(built, prefix_cache="auto")
    toks, off, pager = _port(built, prefix_cache="off")
    assert on["prefix_cache"] is True and on["prefix_hits"] == N_REQ - 1
    assert off["prefix_cache"] is False and off["prefix_hits"] == 0
    assert "prefix_nodes" in on and "prefix_nodes" not in off
    for i in range(N_REQ):
        assert np.array_equal(toks[i], built["ref"][i])
    assert pager.used_pages == 0


def test_chunked_prefill_runs_as_continuation_tasks(built):
    """Every chunk is its own UMT task (re-submitted continuation, not a
    loop in one task): one ``serve.prefill.chunk`` task start per chunk
    on a traced runtime, chunk count by the chunk arithmetic, tokens
    exact (``tests/test_serve_engine.py``'s test, prefix cache off)."""
    from repro_torch.core import UMTRuntime

    chunk = 3
    with UMTRuntime(n_cores=4, umt=True, trace=True) as rt:
        toks, stats, _ = _port(built, rt=rt, prefill_chunk=chunk,
                               prefix_cache="off")
        starts = [e for e in rt.tracer.events if e[1] == "task_start"
                  and "serve.prefill.chunk" in str(e[4])]
    for i in range(N_REQ):
        assert np.array_equal(toks[i], built["ref"][i])
    assert stats["prefill_chunks"] == -(-PLEN // chunk) * stats[
        "prefill_calls"]
    assert len(starts) == stats["prefill_chunk_tasks"] \
        == stats["prefill_chunks"] > 0


def test_tight_pool_drops_the_hold_and_stays_exact(built):
    """Room for one request: a blocked hit drops its page holds (a
    blocked head holds nothing) and is admitted on fresh pages, or on
    its shared pages once they are free again — tokens exact, no leak."""
    need = -(-(PLEN + GEN - 1) // PS)
    toks, stats, pager = _port(built, prefix_cache="on",
                               num_pages=need + 1)
    for i in range(N_REQ):
        assert np.array_equal(toks[i], built["ref"][i])
    assert stats["max_live_slots"] == 1
    assert pager.live_refs == 0 and pager.used_pages == pager.cached_pages


def test_blocked_head_waits_while_a_hit_holds_its_pages(built):
    """Forced interleaving: room for one request; a prefix hit's chain is
    held (its chunk step waits on an event) while the hit holds two of
    the trie's pages, and a cold request queued behind it becomes the
    head of admission, blocked on those pages with nothing live.  The
    decode driver must wait on its doorbell, not spin: over a 0.5 s hold
    its insert pass runs a few times (one per ``idle_wait`` at most),
    where a spin runs it thousands of times.  Released, both requests
    finish exact and no page leaks."""
    import threading

    b = built
    cold = np.random.default_rng(5).integers(
        0, b["cfg"].vocab, (1, PLEN)).astype(np.int32)
    cold_ref = greedy_oneshot(make_prefill_step(b["cfg"], cache_len=CACHE_LEN),
                              make_serve_step(b["cfg"]), b["params"],
                              torch.tensor(cold), None, GEN).numpy()[0]
    need = -(-(PLEN + GEN - 1) // PS)
    eng = ServeEngine(b["cfg"], b["params"], slots=3, cache_len=CACHE_LEN,
                      n_cores=4, page_size=PS, paged_kernel=True,
                      num_pages=need + 1, prefix_cache="on",
                      device="cpu").start()
    reqs = [Request(0, b["prompts"][0], max_new_tokens=GEN),
            Request(1, b["prompts"][1], max_new_tokens=GEN),
            Request(2, cold[0], max_new_tokens=GEN)]
    eng.submit(reqs[0])
    if not reqs[0].done.wait(TIMEOUT_S):
        abandon(eng, "request 0 not done")
    entered, go = threading.Event(), threading.Event()
    chunk = eng.chunk

    def held_chunk(*a, **kw):
        entered.set()
        assert go.wait(TIMEOUT_S)
        return chunk(*a, **kw)
    eng.chunk = held_chunk
    passes = [0]
    do_inserts = eng._do_inserts

    def counted():
        passes[0] += 1
        return do_inserts()
    eng._do_inserts = counted
    eng.submit(reqs[1])                 # the hit: holds 2 pages, held
    assert entered.wait(TIMEOUT_S)
    eng.submit(reqs[2])                 # cold: blocks behind the hold
    t0 = time.monotonic()
    while eng._blocked_head != 2:
        if time.monotonic() - t0 > TIMEOUT_S:
            go.set()
            abandon(eng, "the cold request never blocked")
        time.sleep(0.005)
    n0 = passes[0]
    time.sleep(0.5)
    n_held = passes[0] - n0
    go.set()
    stats = drain(eng, reqs, TIMEOUT_S)
    assert n_held <= 0.5 / eng.idle_wait + 20, (
        f"{n_held} insert passes in 0.5 s while blocked: the driver spins")
    assert np.array_equal(reqs[0].wait(), b["ref"][0])
    assert np.array_equal(reqs[1].wait(), b["ref"][1])
    assert np.array_equal(reqs[2].wait(), cold_ref)
    assert stats["prefix_hits"] == 1 and stats["admission_blocks"] >= 1
    assert eng.pager.live_refs == 0
    assert eng.pager.used_pages == eng.pager.cached_pages


# ------------------------------------------------- steps and block table
def test_gather_step_matches_reference(built):
    """A pool of random content, a table row of matched pages + a fork
    source + garbage tail: the gathered row equals the reference's."""
    import jax.numpy as jnp

    from repro import steps as jsteps
    from repro_torch.steps import init_paged_slot_cache, make_prefix_gather_step

    cfg = built["cfg"]
    num_pages = 9
    pool = init_paged_slot_cache(cfg, 2, CACHE_LEN, torch.float32, PS,
                                 num_pages, "cpu")
    rng = np.random.default_rng(3)
    for blk in pool["blocks"]:
        for t in blk.values():
            t.copy_(torch.tensor(rng.standard_normal(t.shape, np.float32)))
    jpool = {"pos": jnp.zeros((2,), jnp.int32),
             "blocks": tuple({k: jnp.asarray(v.numpy()) for k, v in b.items()}
                             for b in pool["blocks"])}
    trow = np.array([5, 2, 7, 0], np.int32)         # 2 full + fork + tail
    got = make_prefix_gather_step(cfg, cache_len=CACHE_LEN, page_size=PS)(
        pool, torch.tensor(trow), 9)
    want = jsteps.make_prefix_gather_step(cfg, cache_len=CACHE_LEN,
                                          page_size=PS)(
        jpool, jnp.asarray(trow), jnp.int32(9))
    assert int(got["pos"]) == int(want["pos"]) == 9
    for gb, wb in zip(got["blocks"], want["blocks"]):
        assert set(gb) == set(wb)
        for k in gb:
            assert tuple(gb[k].shape) == tuple(wb[k].shape)
            np.testing.assert_array_equal(gb[k].numpy(), np.asarray(wb[k]))
    # a fresh row: writing it leaves the pool alone
    leaf = got["blocks"][0][next(iter(got["blocks"][0]))]
    leaf.zero_()
    assert float(pool["blocks"][0][next(iter(got["blocks"][0]))].abs()
                 .sum()) > 0


@pytest.mark.parametrize("k", [0, 1, 3])
def test_bind_slot_pages_masks_exactly_the_shared_pages(k):
    from repro_torch.serve import GARBAGE_PAGE, KVState

    cfg = get("qwen2.5-14b").tiny()
    kv = KVState(cfg, 2, CACHE_LEN, torch.float32, page_size=PS,
                 device="cpu")
    ids = [7, 3, 5]
    row = kv.bind_slot_pages(1, ids, n_shared=k).numpy()
    table = kv.table_dev.numpy()
    assert list(table[1, :3]) == ids                # decode reads them all
    assert list(row[:k]) == [GARBAGE_PAGE] * k      # the insert skips them
    assert list(row[k:3]) == ids[k:]
    assert (row[3:] == GARBAGE_PAGE).all() and (table[1, 3:] == 0).all()
    with pytest.raises(ValueError, match="n_shared"):
        kv.bind_slot_pages(0, ids, n_shared=4)


# ------------------------------------------------------------ the trie
# ``tests/test_serve_pager.py``'s trie tests, run on the reference's
# module and on the port's copy.
@pytest.fixture(params=["reference", "port"])
def trie(request):
    if request.param == "reference":
        from repro.serve import PagePool, PrefixCache
    else:
        from repro_torch.serve import PagePool
        from repro_torch.serve.prefix import PrefixCache

    def make(num_pages=33, page_size=4):
        p = PagePool(num_pages=num_pages, page_size=page_size)
        return p, PrefixCache(p, page_size)
    return make


def test_trie_match_full_pages_then_fork_into_divergent_page(trie):
    p, t = trie()
    toks = np.arange(12)
    ids = p.alloc(3)
    t.insert(toks, ids, 12)
    p.release(ids)
    assert t.n_pages == 3 and p.cached_pages == 3
    q = toks.copy()
    q[9] = 99
    m = t.match_and_lock(q, len(q) - 1)
    assert m.pages == ids[:2] and m.full_tokens == 8
    assert m.fork_src == ids[2] and m.fork_len == 1 and m.tokens == 9
    assert all(p.refcount(i) == 1 for i in ids)
    t.release_fork(m)
    assert p.refcount(ids[2]) == 0
    t.release(m)
    assert p.live_refs == 0


def test_trie_match_is_capped_and_misses_cleanly(trie):
    p, t = trie()
    toks = np.arange(12)
    ids = p.alloc(3)
    t.insert(toks, ids, 12)
    p.release(ids)
    m = t.match_and_lock(toks, len(toks) - 1)
    assert m.tokens == 11 and m.fork_len == 3
    t.release(m)
    miss = t.match_and_lock(np.arange(100, 112), 11)
    assert miss.tokens == 0 and not miss.pages and miss.fork_src is None
    assert p.live_refs == 0


def test_trie_insert_is_first_wins(trie):
    p, t = trie()
    toks = np.arange(8)
    a, b = p.alloc(2), p.alloc(2)
    assert t.insert(toks, a, 8) == 2
    assert t.insert(toks, b, 8) == 0
    m = t.match_and_lock(np.concatenate([toks, [77]]), 8)
    assert m.pages == a
    t.release(m)
    assert p.cached_pages == 2
    p.free(b)


def test_trie_lru_evicts_oldest_ref0_leaf_first(trie):
    p, t = trie()
    old, new = p.alloc(1), p.alloc(1)
    t.insert(np.arange(4), old, 4)
    t.insert(np.arange(50, 54), new, 4)
    m = t.match_and_lock(np.concatenate([np.arange(4), [9]]), 4)
    t.release(m)
    p.release(old + new)
    assert t.evict_lru(1) == 1
    assert p.is_cached(old[0]) and not p.is_cached(new[0])


def test_trie_lru_skips_held_pages_and_interior_nodes(trie):
    p, t = trie()
    ids = p.alloc(3)
    t.insert(np.arange(12), ids, 12)
    p.release(ids)
    m = t.match_and_lock(np.arange(12), 11)
    assert t.evict_lru(3) == 0
    t.release(m)
    free0 = p.free_pages
    assert t.evict_lru(1) == 1 and p.free_pages == free0 + 1
    assert t.evict_lru(2) == 2 and p.free_pages == free0 + 3
    assert t.n_pages == 0


def test_trie_page_size_one_degenerate(trie):
    p, t = trie(num_pages=9, page_size=1)
    ids = p.alloc(4)
    t.insert(np.asarray([5, 6, 7, 8]), ids, 4)
    m = t.match_and_lock(np.asarray([5, 6, 9]), 2)
    assert m.tokens == 2 and m.pages == ids[:2]
    assert m.fork_src is None
    t.release(m)
    p.release(ids)
    assert t.evict_lru(9) == 4 and p.used_pages == 0


def test_trie_clear_uncaches_everything(trie):
    p, t = trie()
    ids = p.alloc(2)
    t.insert(np.arange(8), ids, 8)
    held = p.alloc(1)
    t.insert(np.arange(100, 104), held, 4)
    p.release(ids)
    assert t.clear() == 2
    assert p.used_pages == 1 and not p.is_cached(held[0])
    p.release(held)
    assert p.used_pages == 0
