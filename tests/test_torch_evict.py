"""On-demand paging with eviction and restore in the port
(``policy="ondemand"``): the port's counterpart of
``tests/test_serve_evict.py``, at tiny sizes in f32 on the CPU.

Weights come from the reference's ``init_params`` through
``repro_torch.params``, prompts from a numpy seed.  Every stream is held
exactly to the port's one-shot tokens (the never-evicted run) and, for
the organic evictions of a tight pool, to the reference engine's tokens
on the same inputs; every pool drains clean (no page held, every used
page the trie's); no restore re-derives a token other than the one
emitted (``restore_divergences == 0``; on the CPU a divergence raises, as
the reference's assertion does).  Every engine drains under a deadline
(``repro_torch.serve.drain``).

Restore shapes: prefill-replay through the chunk step on the
chunk-exact configs (qwen2.5-14b, minicpm3-4b, and the frontends:
internvl2-2b, whose patches ride the replay's first chunk and which never
re-hits the trie, and musicgen-large over (P, K) codebook ids),
decode-replay through the serve step on SSD (mamba2-780m) and MoE +
sliding-window rings (mixtral-8x7b).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get
from repro.models.lm import init_params as jax_init_params
from repro_torch.params import params_from_numpy
from repro_torch.serve import (KVState, OnDemandPolicy, Request,
                               SchedulerPolicy, ServeEngine, SlotView, drain,
                               make_policy)
from test_torch_engine import frontend_inputs, oneshot

ARCHS = ["qwen2.5-14b", "minicpm3-4b", "mamba2-780m", "mixtral-8x7b",
         "internvl2-2b", "musicgen-large"]
N_REQ, PLEN, GEN, PS = 6, 8, 6, 2      # small pages: growth fires
CACHE_LEN = PLEN + GEN
TIMEOUT_S = 120
P_PAGES = -(-PLEN // PS)                # a prompt's pages
W_PAGES = -(-(PLEN + GEN - 1) // PS)    # a request's worst case


@pytest.fixture(scope="module")
def built():
    return {}


def _build(arch, built):
    if arch not in built:
        cfg = get(arch).tiny()
        jp = jax_init_params(cfg, jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
        prompts, patches = frontend_inputs(cfg, N_REQ, PLEN)
        ref = oneshot(cfg, params, prompts, patches, GEN, CACHE_LEN)
        built[arch] = dict(cfg=cfg, jp=jp, params=params, prompts=prompts,
                           patches=patches, ref=ref)
    return built[arch]


def _requests(b, cls=Request, gens=None, eos=None, stop=None):
    return [cls(i, b["prompts"][i],
                patches=None if b["patches"] is None else b["patches"][i],
                max_new_tokens=GEN if gens is None else int(gens[i]),
                eos_id=None if eos is None else eos[i],
                stop=None if stop is None else stop[i])
            for i in range(N_REQ)]


def _port(b, policy, *, page_size=PS, paged_kernel=True, **kw):
    """One port engine over the request set; every stream held to its
    one-shot row (a prefix of it under eos/stop), the pool drained clean,
    no restore divergence.  Returns (stats, tokens)."""
    reqs = _requests(b, gens=kw.pop("gens", None), eos=kw.pop("eos", None),
                     stop=kw.pop("stop", None))
    eng = ServeEngine(b["cfg"], b["params"], slots=kw.pop("slots", 3),
                      cache_len=CACHE_LEN, n_cores=4, page_size=page_size,
                      paged_kernel=paged_kernel and page_size is not None,
                      policy=policy, device="cpu", **kw).start()
    for r in reqs:
        eng.submit(r)
    stats = drain(eng, reqs, TIMEOUT_S)
    toks = []
    for r in reqs:
        got = np.asarray(r.wait(), np.int32)
        want = b["ref"][r.rid, :len(got)]
        assert np.array_equal(got, want), (
            f"request {r.rid}: evict/restore diverged from the never-"
            f"evicted run\n got {got}\nwant {want}")
        assert len(got) == r.max_new or r.stopped
        toks.append(got)
    if eng.pager is not None:
        assert eng.pager.live_refs == 0, "page refs leaked across evictions"
        assert eng.pager.used_pages == eng.pager.cached_pages, (
            "pages leaked across evictions")
    assert stats["restore_divergences"] == 0 == len(eng.restore_divergences)
    return stats, toks


class FuzzEvictPolicy(SchedulerPolicy):
    """Forced preemption: every ``period`` ticks, evict a random live slot
    (``tests/test_serve_evict.py``'s policy)."""

    def __init__(self, seed, period=3, max_evictions=4):
        self.rng = np.random.default_rng(seed)
        self.period = period
        self.left = max_evictions
        self.ticks = 0

    def maybe_evict(self, eng, views):
        self.ticks += 1
        if self.left <= 0 or not views or self.ticks % self.period:
            return None
        self.left -= 1
        return int(self.rng.choice([v.slot for v in views]))


class OnDemandFuzzEvict(FuzzEvictPolicy, OnDemandPolicy):
    """Fuzz evictions on top of on-demand admission and growth."""
    name = "ondemand"
    on_demand = True


# ------------------------------------------------------- policy units
def test_make_policy_resolution():
    assert make_policy(None).name == "reserve"
    assert make_policy("ondemand").on_demand
    p = OnDemandPolicy()
    assert make_policy(p) is p
    with pytest.raises(ValueError, match="unknown policy"):
        make_policy("nope")
    with pytest.raises(TypeError):
        make_policy(42)


def test_ondemand_victim_is_youngest():
    views = [SlotView(slot=s, rid=s, admit_seq=seq, pages_held=2,
                      next_pos=9, emitted=2, budget=6)
             for s, seq in ((0, 5), (1, 9), (2, 7))]
    assert OnDemandPolicy().select_victim(None, views) == 1
    assert OnDemandPolicy().select_victim(None, []) is None
    assert SchedulerPolicy().select_victim(None, views) is None


def test_ondemand_policy_needs_a_paged_engine():
    cfg = get("qwen2.5-14b").tiny()
    with pytest.raises(ValueError, match="on-demand"):
        ServeEngine(cfg, lambda: None, slots=2, cache_len=8, page_size=None,
                    policy="ondemand", device="cpu")


def test_grow_slot_pages_writes_the_host_table_only():
    cfg = get("qwen2.5-14b").tiny()
    kv = KVState(cfg, 2, CACHE_LEN, torch.float32, page_size=PS,
                 device="cpu")
    kv.bind_slot_pages(1, [4, 6])
    dev = kv.table_dev
    kv.grow_slot_pages(1, [9], base=2)
    assert list(kv._table[1, :4]) == [4, 6, 9, 0]
    assert kv.table_dev is dev and int(dev[1, 2]) == 0   # not published
    kv.sync_table()
    assert list(kv.table_dev[1, :4].numpy()) == [4, 6, 9, 0]
    with pytest.raises(ValueError, match="live table entries"):
        kv.grow_slot_pages(1, [3], base=1)
    with pytest.raises(ValueError, match="exceeds"):
        kv.grow_slot_pages(1, [3], base=CACHE_LEN // PS)


# ------------------------------------------------- organic evictions
@pytest.mark.parametrize("arch", ARCHS)
def test_evict_restore_under_a_tight_pool_equals_oneshot_and_reference(
        arch, built):
    """On-demand paging into a pool two requests can enter but cannot
    both finish in: growth collides, the youngest slot is evicted and
    restored (prefill-replay on qwen2.5-14b, minicpm3-4b and the two
    frontends, decode-replay on mamba2-780m and mixtral-8x7b).  The
    tokens equal the never-evicted one-shot run, bit for bit, and the
    reference engine's on the same inputs and pool.

    The reference engine runs with its prefix cache off.  With it on, a
    blocked head drops only its own prefix hold while the rows queued
    behind it keep theirs (``repro/serve/engine.py``, ``_do_inserts``),
    so whether the pool frees depends on how the worker threads
    interleave: under load it never did (the reference's decode loop
    failed 6.1 million page allocations in 120 s, no slot live, the
    queued holds pinning the pages; ROADMAP queue 3).  The port's own
    engine keeps its prefix cache (``_drop_queued_holds``).  The tokens
    do not depend on the cache: both runs are still held to the port's
    one-shot rows bit for bit, and each must evict and restore."""
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine

    b = _build(arch, built)
    assert W_PAGES > P_PAGES, "geometry must force mid-decode growth"
    stats, toks = _port(b, "ondemand", num_pages=P_PAGES + W_PAGES)
    assert stats["policy"] == "ondemand"
    assert stats["pages_grown"] > 0
    assert stats["evictions"] > 0, "tight pool never evicted"
    assert stats["restores"] == stats["evictions"]

    jreqs = _requests(b, JRequest)
    eng = JServeEngine(b["cfg"], b["jp"], slots=3, cache_len=CACHE_LEN,
                       n_cores=4, page_size=PS, num_pages=P_PAGES + W_PAGES,
                       policy="ondemand", paged_kernel=True,
                       prefix_cache="off").start()
    for r in jreqs:
        eng.submit(r)
    jstats = drain(eng, jreqs, TIMEOUT_S)
    for r, got in zip(jreqs, toks):
        assert np.array_equal(np.asarray(r.wait(), np.int32), got), (
            f"request {r.rid}: the port's tokens differ from the "
            "reference engine's")
    assert jstats["evictions"] > 0 and jstats["restores"] == \
        jstats["evictions"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ondemand_never_deadlocks_at_one_worst_case(seed, built):
    """Capacity exactly one request's worst case (the least admission
    allows), fuzzed budgets, every slot fighting for pages: the engine
    drains within the deadline, every stream exact, every page back."""
    b = _build("qwen2.5-14b", built)
    gens = np.random.default_rng(seed).integers(1, GEN + 1, N_REQ)
    stats, _ = _port(b, "ondemand", num_pages=W_PAGES + 1, gens=gens)
    assert stats["requests"] == N_REQ
    assert stats["admission_blocks"] + stats["evictions"] > 0


# ---------------------------------------------------- forced evictions
@pytest.mark.parametrize("layout", ["dense", "paged", "kernel"])
def test_forced_fuzz_evictions_stay_exact(layout, built):
    """Forced fuzz evictions on a dense engine (reserve policy: its
    allocator never preempts), a paged one and a paged-kernel one (both
    on-demand), with an eos request whose stop may fire before an
    eviction: the restore must not re-emit or re-stop."""
    b = _build("qwen2.5-14b", built)
    policy = (FuzzEvictPolicy(seed=7) if layout == "dense"
              else OnDemandFuzzEvict(seed=7))
    eos = [None] * N_REQ
    eos[0] = int(b["ref"][0, 2])        # stops at its third token
    stats, _ = _port(b, policy, page_size=None if layout == "dense" else PS,
                     paged_kernel=layout == "kernel", eos=eos)
    assert stats["evictions"] > 0
    assert stats["restores"] == stats["evictions"]
    assert stats["paged_kernel"] is (layout == "kernel")
    assert stats["stopped_early"] >= 1


@pytest.mark.parametrize("arch,kind", [("qwen2.5-14b", "eos"),
                                       ("qwen2.5-14b", "stop"),
                                       ("mixtral-8x7b", "eos"),
                                       ("mixtral-8x7b", "stop")])
def test_stop_fires_after_restore_on_both_replay_paths(arch, kind, built):
    """A stop that completes late in the stream meets evictions that land
    before it: it fires after the restore, on prefill-replay (qwen2.5-14b)
    and decode-replay (mixtral-8x7b) alike."""
    b = _build(arch, built)
    ref = b["ref"]
    eos = stop = None
    if kind == "eos":
        eos = [int(ref[i, GEN - 2]) for i in range(N_REQ)]
    else:
        stop = [[[int(ref[i, GEN - 3]), int(ref[i, GEN - 2])]]
                for i in range(N_REQ)]
    policy = OnDemandFuzzEvict(seed=13, period=2, max_evictions=6)
    stats, _ = _port(b, policy, eos=eos, stop=stop)
    assert stats["evictions"] > 0
    assert stats["restores"] == stats["evictions"]
    assert stats["stopped_early"] > 0, "the stop tokens never matched"


def test_restore_rehits_the_trie(built):
    """An evicted slot's written pages become trie capital: with unique
    prompts the only possible hit is a restore matching the pages its
    own eviction handed over."""
    b = _build("qwen2.5-14b", built)
    stats, _ = _port(b, OnDemandFuzzEvict(seed=11))
    assert stats["restores"] > 0
    assert stats["prefix_hits"] >= stats["restores"], (
        "a restore replayed its prefill cold instead of re-hitting the "
        "trie")
    assert stats["prefix_tokens_saved"] > 0


@pytest.mark.parametrize("arch", ["internvl2-2b", "musicgen-large"])
def test_frontend_restores_under_fuzz_evictions(arch, built):
    """Forced evictions on both frontends: every restore re-derives the
    emitted stream bit for bit (prefill-replay with the patches on the
    replay's first chunk; over (P, K) codebook ids).  The evicted pages
    enter the trie, so a restore of an audio request re-hits them; a
    vision request's key lacks its patches, so nothing of it is cached
    and nothing hits."""
    b = _build(arch, built)
    stats, _ = _port(b, OnDemandFuzzEvict(seed=11))
    assert stats["evictions"] > 0
    assert stats["restores"] == stats["evictions"]
    if b["patches"] is not None:
        assert stats["prefix_lookups"] == 0 == stats["prefix_inserted_pages"]
    else:
        assert stats["prefix_hits"] >= stats["restores"]


def test_reserve_policy_never_faults_or_evicts(built):
    b = _build("qwen2.5-14b", built)
    stats, _ = _port(b, None, num_pages=W_PAGES + 1)
    assert stats["policy"] == "reserve"
    assert stats["pages_grown"] == 0 == stats["pages_grown_multi"]
    assert stats["evictions"] == 0 == stats["restores"]


# ------------------------------------------------- the restore check
class EvictOnce(OnDemandFuzzEvict):
    """Evicts slot 0's request once, at its third tick."""

    def __init__(self):
        super().__init__(seed=0, period=3, max_evictions=1)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-780m"])
@pytest.mark.parametrize("strict", [True, False])
def test_a_restore_that_rederives_another_token_is_caught(arch, strict,
                                                          built):
    """Planted: the emitted stream's last token is changed between the
    eviction and its restore, so the restore (prefill-replay on
    qwen2.5-14b, decode-replay on mamba2-780m) re-derives another token.
    ``strict_restore`` (the CPU default) fails the request with the
    reference's assertion; without it (the card's mode) the divergence is
    recorded and the recorded token is fed on."""
    b = _build(arch, built)
    eng = ServeEngine(b["cfg"], b["params"], slots=1, cache_len=CACHE_LEN,
                      n_cores=4, page_size=PS, policy=EvictOnce(),
                      device="cpu").start()
    assert eng.strict_restore
    eng.strict_restore = strict
    evict = eng._evict_slot
    planted = {}

    def evict_and_plant(s):
        req = eng._slot_req[s]
        eng._materialise_tokens(req)
        k = len(req.out_tokens) - 1
        planted[req.rid] = (k, int(req.out_tokens[k]))
        req.out_tokens[k] = (int(req.out_tokens[k]) + 1) % b["cfg"].vocab
        evict(s)
    eng._evict_slot = evict_and_plant
    req = Request(0, b["prompts"][0], max_new_tokens=GEN)
    eng.submit(req)
    stats = drain(eng, [req], TIMEOUT_S)
    assert stats["evictions"] == 1 and planted
    k, was = planted[0]
    if strict:
        with pytest.raises(AssertionError, match="restore diverged"):
            req.wait()
        assert stats["restores"] == 0
    else:
        out = req.wait()
        assert int(out[k]) == (was + 1) % b["cfg"].vocab   # fed on
        assert stats["restores"] == 1
        assert stats["restore_divergences"] == 1
        rid, pos, want, got = eng.restore_divergences[0]
        assert (rid, pos, want) == (0, k, (was + 1) % b["cfg"].vocab)
        assert got == was


class JumpTheQueue(SchedulerPolicy):
    """Once, between an admission's look at the head of the insert queue
    and its removal of that entry, the queue's last row moves to its head:
    what a restore's prefill round does from its own thread
    (``appendleft``, the restore outranking new arrivals)."""

    def __init__(self):
        self.jumped = False

    def admission_tokens(self, eng, req):
        if not self.jumped and len(eng._inserts) >= 2:
            with eng._lock:
                eng._inserts.rotate(1)
            self.jumped = True
        return super().admission_tokens(eng, req)


def test_a_row_that_jumps_the_queue_mid_admission_is_not_lost(built):
    """The port's repair of ``_do_inserts`` (ROADMAP queue 3): the entry
    admitted is the one taken off the queue.  Popping the head instead
    dropped the row that had moved there, whose request never finished,
    and left the admitted one queued to be admitted again into a second
    slot, whose table then outgrew its pages ("growing over live table
    entries"): under load, in about one run in ten of the tight-pool
    test."""
    b = _build("qwen2.5-14b", built)
    pol = JumpTheQueue()
    _, toks = _port(b, pol)
    assert pol.jumped, "the queue never held two rows at an admission"
    for i, got in enumerate(toks):
        assert np.array_equal(got, b["ref"][i])
