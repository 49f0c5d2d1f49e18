"""Speculative decoding (draft and verify) in the port: the verify step,
its window writes and the engine's speculative tick, against the
reference (``tests/test_serve_steps.py`` and the spec tests of
``tests/test_serve_engine.py`` / ``tests/test_serve_evict.py``) and
against the port's own spec-off leg.

CPU, f32, the tiny configs of qwen2.5-14b (GQA) and minicpm3-4b (MLA),
and of internvl2-2b (GQA behind patch embeddings, on the engine's paths:
its spec-on tokens are held to its own spec-off leg, as the reference's
``test_spec_decode_bit_exact_under_eviction_churn[internvl2-2b]`` fails
in this environment); musicgen-large's audio frontend is refused spec
and eos/stop with the reference's errors.  Weights from the reference's
``init_params`` through ``repro_torch.params``, prompts from a numpy
seed.  Tokens are held
exactly.  Logits and cache leaves are held to the reference's within
``TOL`` (rtol 1e-4, atol 1e-5, the model tests' f32 bound): the port
scores a GQA window with each KV head's query heads grouped into one
block of rows where the reference expands K/V per query head — the same
dot products summed in another order, about 1e-6 apart here.  The
reference's two spec tests that fail in this environment
(``test_spec_decode_bit_exact_under_eviction_churn[internvl2-2b]``,
``test_spec_with_prefix_cache_bit_exact``) are not used as oracles: spec
over fuzz evictions and over a warm prefix trie is held to the port's
spec-off leg and to its one-shot tokens.  Every engine drains
under a deadline (``repro_torch.serve.drain``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get
from repro.models import lm as jlm
from repro.models.lm import init_params as jax_init_params
from repro_torch.models import lm as tlm
from repro_torch.params import params_from_numpy
from repro_torch.serve import (OnDemandPolicy, Request, SchedulerPolicy,
                               ServeEngine, drain)
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.spec import Drafter, NgramDrafter, make_drafter
from repro_torch.steps import (greedy_oneshot, init_paged_slot_cache,
                               init_slot_cache, make_batched_insert_step,
                               make_decode_step, make_prefill_step,
                               make_serve_step, make_verify_step,
                               speculatable)
from test_torch_engine import frontend_inputs
from test_torch_evict import OnDemandFuzzEvict

ARCHS = ["qwen2.5-14b", "minicpm3-4b"]
ENGINE_ARCHS = ARCHS + ["internvl2-2b"]
SLOTS, N_REQ, PLEN, GEN = 3, 6, 8, 16
CACHE_LEN = PLEN + GEN
TOL = dict(rtol=1e-4, atol=1e-5)
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def built():
    return {}


def _build(arch, built):
    if arch not in built:
        cfg = get(arch).tiny()
        jp = jax_init_params(cfg, jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
        # a vision prompt: fewer text tokens behind its patches, the same
        # cache extent
        prompts, patches = frontend_inputs(cfg, N_REQ, PLEN)
        # templated prompts: a 2-token motif tiled, so prompt lookup drafts
        # from the first tick (the reference engine test's workload)
        motif = np.tile(prompts[:, :2], (1, prompts.shape[1] // 2))
        prefill = make_prefill_step(cfg, cache_len=CACHE_LEN)
        pt = None if patches is None else torch.tensor(patches)

        def oneshot(p):
            return greedy_oneshot(prefill, make_serve_step(cfg), params,
                                  torch.tensor(p), pt, GEN).numpy()
        built[arch] = dict(cfg=cfg, jp=jp, params=params, prompts=prompts,
                           patches=patches, ref=oneshot(prompts), motif=motif,
                           motif_ref=oneshot(motif), prefill=prefill)
    return built[arch]


def _reqs(b, prompts, **kw):
    """One request per prompt, each with its patches where it has them."""
    return [Request(i, p, max_new_tokens=GEN,
                    patches=None if b["patches"] is None else b["patches"][i],
                    **kw) for i, p in enumerate(prompts)]


def _to_jax(cache):
    return {"pos": jnp.asarray(cache["pos"].numpy()),
            "blocks": tuple({k: jnp.asarray(v.numpy()) for k, v in b.items()}
                            for b in cache["blocks"])}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# ----------------------------------------------------------- the verify step
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_verify_step_matches_the_reference(arch, layout, built):
    """One verify dispatch over a random cache, both packages on the same
    inputs: a full window, a short one (masked lanes) and a dead slot
    (n_tok 0).  The paged leg uses page size 1, so the window crosses a
    page at every lane.  Argmaxes equal; logits of every lane and the
    cache leaves within ``TOL``; positions no valid lane writes are left
    as they were (the reference drops those writes).  The dead slot reads
    garbage page 0, whose content is unspecified on both sides, so its
    rows and that page are left out of the paged comparison."""
    from repro.steps import make_verify_step as j_make_verify_step

    b = _build(arch, built)
    cfg = b["cfg"]
    rng = np.random.default_rng(2)
    s = 4
    pos = np.array([5, 9, 3], np.int32)
    n_tok = np.array([s, 2, 0], np.int32)
    toks = rng.integers(0, cfg.vocab, (SLOTS, s)).astype(np.int32)
    paged = layout == "paged"
    ps = 1 if paged else None
    if paged:
        num_pages = SLOTS * CACHE_LEN + 1
        cache = init_paged_slot_cache(cfg, SLOTS, CACHE_LEN, torch.float32,
                                      ps, num_pages, "cpu")
        table = (1 + rng.permutation(SLOTS * CACHE_LEN)).reshape(
            SLOTS, CACHE_LEN).astype(np.int32)
        table[2] = 0                                   # the dead slot
    else:
        cache = init_slot_cache(cfg, SLOTS, CACHE_LEN, torch.float32, "cpu")
    for blk in cache["blocks"]:
        for leaf in blk.values():
            leaf.copy_(torch.from_numpy(
                rng.standard_normal(leaf.shape).astype(np.float32)))
    before = {k: v.clone() for k, v in cache["blocks"][0].items()}
    jcache = _to_jax(cache)

    t_args = (torch.tensor(toks), torch.tensor(pos), torch.tensor(n_tok))
    j_args = (jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(n_tok))
    t_pages = j_pages = None
    if paged:
        t_args += (torch.tensor(table),)
        j_args += (jnp.asarray(table),)
        t_pages = {"table": torch.tensor(table), "page_size": ps,
                   "cache_len": CACHE_LEN, "kernel": False}
        j_pages = dict(t_pages, table=jnp.asarray(table))
    live = slice(0, 2) if paged else slice(None)

    # logits of every lane, masked lanes included
    t_out = tlm.forward(b["params"], cfg, t_args[0], mode="verify",
                        pos=t_args[1], cache={"pos": cache["pos"],
                        "blocks": tuple({k: v.clone() for k, v in bl.items()}
                                        for bl in cache["blocks"])},
                        cache_len=CACHE_LEN, pages=t_pages, n_tok=t_args[2])
    j_out = jlm.forward(b["jp"], cfg, j_args[0], mode="verify", pos=j_args[1],
                        cache=jcache, cache_len=CACHE_LEN, pages=j_pages,
                        n_tok=j_args[2])
    _close(t_out["logits"].numpy()[live], np.asarray(j_out["logits"])[live])

    t_nxt, t_cache = make_verify_step(cfg, cache_len=CACHE_LEN,
                                      page_size=ps)(b["params"], cache,
                                                    *t_args)
    j_nxt, j_cache = j_make_verify_step(cfg, cache_len=CACHE_LEN,
                                        page_size=ps)(b["jp"], jcache,
                                                      *j_args)
    np.testing.assert_array_equal(t_nxt.numpy()[live],
                                  np.asarray(j_nxt)[live])
    assert t_nxt.dtype == torch.int32 and tuple(t_nxt.shape) == (SLOTS, s)
    np.testing.assert_array_equal(t_cache["pos"].numpy(),
                                  np.asarray(j_cache["pos"]))
    for tb, jb in zip(t_cache["blocks"], j_cache["blocks"]):
        for name, leaf in tb.items():
            got, want = leaf.numpy(), np.asarray(jb[name])
            if paged:
                got, want = got[:, 1:], want[:, 1:]
            _close(got, want)
    # what no valid lane writes is left as it was
    for name, old in before.items():
        new = t_cache["blocks"][0][name]
        if paged:
            written = {int(table[b_, p + j]) for b_, p, n in
                       zip(range(SLOTS), pos, n_tok) for j in range(n)}
            kept = [q for q in range(1, new.shape[1]) if q not in written]
            torch.testing.assert_close(new[:, kept], old[:, kept], rtol=0,
                                       atol=0)
        else:
            for b_ in range(SLOTS):
                kept = [q for q in range(CACHE_LEN)
                        if not pos[b_] <= q < pos[b_] + n_tok[b_]]
                torch.testing.assert_close(new[:, b_, kept],
                                           old[:, b_, kept], rtol=0, atol=0)


def _prefilled_pool(b, paged):
    """Each prompt prefilled and inserted into its own slot: the pool, the
    block table (page size 1, every page bound) and the first tokens."""
    cfg = b["cfg"]
    ps = 1 if paged else None
    if paged:
        num_pages = SLOTS * CACHE_LEN + 1
        pool = init_paged_slot_cache(cfg, SLOTS, CACHE_LEN, torch.float32,
                                     ps, num_pages, "cpu")
        table = torch.arange(1, num_pages, dtype=torch.int32).view(
            SLOTS, CACHE_LEN).flip(1).contiguous()     # pages out of order
    else:
        pool = init_slot_cache(cfg, SLOTS, CACHE_LEN, torch.float32, "cpu")
        table = None
    insert = make_batched_insert_step(cfg, cache_len=CACHE_LEN, page_size=ps)
    rows, logits = b["prefill"](b["params"],
                                torch.tensor(b["prompts"][:SLOTS]))
    for s in range(SLOTS):
        pool = (insert(pool, rows, s, s, table[s]) if paged
                else insert(pool, rows, s, s))
    return pool, table, logits.argmax(-1).int()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_verify_s1_ticks_equal_decode_ticks(arch, layout, built):
    """Driving the pool through S=1 verify windows alone (host positions)
    gives the port's own decode-tick tokens, and the one-shot tokens."""
    b = _build(arch, built)
    cfg, paged = b["cfg"], layout == "paged"
    ps = 1 if paged else None
    streams = {}
    for leg in ("decode", "verify"):
        pool, table, tok = _prefilled_pool(b, paged)
        extra = (table,) if paged else ()
        out = [tok]
        if leg == "decode":
            step = make_decode_step(cfg, cache_len=CACHE_LEN, page_size=ps)
            active = torch.ones(SLOTS, dtype=torch.bool)
            for _ in range(GEN - 1):
                tok, pool = step(b["params"], pool, tok, active, *extra)
                out.append(tok)
        else:
            step = make_verify_step(cfg, cache_len=CACHE_LEN, page_size=ps)
            pos = torch.full((SLOTS,), PLEN, dtype=torch.int32)
            ones = torch.ones(SLOTS, dtype=torch.int32)
            for _ in range(GEN - 1):
                tok, pool = step(b["params"], pool, tok, pos, ones, *extra)
                out.append(tok)
                pos = pos + 1
        streams[leg] = torch.cat(out, dim=1).numpy()
    np.testing.assert_array_equal(streams["verify"], streams["decode"])
    np.testing.assert_array_equal(streams["verify"], b["ref"][:SLOTS])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_verify_window_scores_the_decode_stream(arch, layout, built):
    """One window over slot 0 with the stream's own next tokens as drafts:
    lane i's argmax is the token tick-by-tick decode emits at i + 1.  A
    corrupted last lane leaves the lanes before it equal (the causal mask
    inside the window), and the perfect window run again afterwards on
    the same cache still agrees on every lane (rejected lanes need no
    rollback).  The other slots are dead (n_tok 0)."""
    b = _build(arch, built)
    cfg, paged = b["cfg"], layout == "paged"
    ref = b["ref"]
    k = GEN - 2                                 # drafts: S = k + 1 lanes
    pool, table, _ = _prefilled_pool(b, paged)
    step = make_verify_step(cfg, cache_len=CACHE_LEN,
                            page_size=1 if paged else None)
    pos = torch.tensor([PLEN, 0, 0], dtype=torch.int32)
    n_tok = torch.tensor([k + 1, 0, 0], dtype=torch.int32)

    def dispatch(draft):
        nonlocal pool
        toks = torch.zeros((SLOTS, k + 1), dtype=torch.int32)
        toks[0, 0] = int(ref[0, 0])
        toks[0, 1:] = torch.tensor(draft)
        nxt, pool = step(b["params"], pool, toks, pos, n_tok,
                         *((table,) if paged else ()))
        return nxt[0].numpy()

    perfect = ref[0, 1:1 + k].copy()
    np.testing.assert_array_equal(dispatch(perfect), ref[0, 1:])
    bad = perfect.copy()
    bad[-1] = (bad[-1] + 1) % cfg.vocab
    np.testing.assert_array_equal(dispatch(bad)[:k], ref[0, 1:1 + k])
    np.testing.assert_array_equal(dispatch(perfect), ref[0, 1:])


def test_speculatable_gate_refuses_extent_bound_configs():
    """MoE capacity, the SSD state and the audio frontend cannot verify a
    window exactly: the step and the engine refuse them with ValueError
    (the reference's engine error; its step asserts)."""
    for arch in ("mixtral-8x7b", "jamba-v0.1-52b", "musicgen-large"):
        cfg = get(arch).tiny()
        assert not speculatable(cfg, 16)
        with pytest.raises(ValueError, match="speculative decoding"):
            make_verify_step(cfg, cache_len=16)
    cfg = get("mixtral-8x7b").tiny()
    with pytest.raises(ValueError, match="speculative decoding"):
        ServeEngine(cfg, lambda: None, cache_len=16, spec="ngram",
                    device="cpu")
    assert speculatable(get("qwen2.5-14b").tiny(), 16)
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(get("qwen2.5-14b").tiny(), lambda: None, cache_len=16,
                    spec="ngram", spec_k=0, device="cpu")


def test_accept_window_commits_argmaxes_never_drafts():
    assert engine_mod.accept_window([5, 6, 7], [5, 6, 9, 4]) == (2, [5, 6, 9])
    assert engine_mod.accept_window([5, 6], [1, 6, 7]) == (0, [1])
    assert engine_mod.accept_window([], [3]) == (0, [3])
    assert engine_mod.accept_window([2, 3], [2, 3, 8]) == (2, [2, 3, 8])


# ----------------------------------------------------------------- drafters
def test_make_drafter_parses_specs():
    d = make_drafter("ngram")
    assert isinstance(d, NgramDrafter)
    assert (d.max_ngram, d.min_ngram) == (3, 1)
    assert (make_drafter("ngram:4,2").max_ngram,
            make_drafter("ngram:4,2").min_ngram) == (4, 2)
    assert make_drafter("ngram:5").max_ngram == 5
    mine = NgramDrafter()
    assert make_drafter(mine) is mine
    with pytest.raises(ValueError, match="unknown drafter"):
        make_drafter("model")
    with pytest.raises(NotImplementedError):
        Drafter().draft([1, 2], 1)
    assert d.draft([7, 8, 9, 1, 7, 8], 2) == [9, 1]
    assert d.draft([4, 5, 6, 4, 5, 7, 4, 5], 1) == [7]
    assert d.draft([1, 2, 3], 2) == []


def test_policy_abandons_speculation_per_request():
    from types import SimpleNamespace

    pol = SchedulerPolicy()
    eng = SimpleNamespace(spec_k=4)
    assert pol.spec_draft_k(eng, Request(0, None)) == 4     # warm-up
    bad = Request(1, None)
    bad.spec_drafted, bad.spec_accepted = 20, 1
    assert pol.spec_draft_k(eng, bad) == 0
    good = Request(2, None)
    good.spec_drafted, good.spec_accepted = 20, 10
    assert pol.spec_draft_k(eng, good) == 4


# ------------------------------------------------------------------- engine
def _engine(b, reqs, **kw):
    kw.setdefault("slots", SLOTS)
    eng = ServeEngine(b["cfg"], b["params"], cache_len=CACHE_LEN, n_cores=4,
                      device="cpu", **kw).start()
    for r in reqs:
        eng.submit(r)
    stats = drain(eng, reqs, TIMEOUT_S)
    if eng.pager is not None:
        assert eng.pager.live_refs == 0
        assert eng.pager.used_pages == eng.pager.cached_pages
    return stats, [list(np.asarray(r.wait(), np.int32)) for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_on_equals_spec_off_and_the_reference_engine(arch, built):
    """Templated prompts (prompt lookup drafts from the first tick), one
    stream with an EOS that falls inside a window: spec-on tokens equal
    spec-off tokens, the one-shot tokens (a prefix ending at the EOS) and
    the reference engine's spec-on tokens; spec drafts and accepts, and
    spends fewer dispatches per token.  One slot: every accepted draft
    saves a dispatch (with several, the longest stream of a wave sets the
    number of ticks)."""
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine

    b = _build(arch, built)
    ref = b["motif_ref"]
    eos = int(ref[0, GEN - 2])

    def reqs(cls=Request):
        return [cls(i, b["motif"][i], max_new_tokens=GEN,
                    eos_id=eos if i == 0 else None) for i in range(N_REQ)]

    kw = dict(slots=1, page_size=4, paged_kernel=True, spec_k=3)
    off, toks_off = _engine(b, reqs(), **kw)
    on, toks_on = _engine(b, reqs(), spec="ngram", **kw)
    jreqs = reqs(JRequest)
    jeng = JServeEngine(b["cfg"], b["jp"], slots=1, cache_len=CACHE_LEN,
                        n_cores=4, page_size=4, paged_kernel=True,
                        spec="ngram", spec_k=3).start()
    for r in jreqs:
        jeng.submit(r)
    jstats = drain(jeng, jreqs, TIMEOUT_S)
    assert toks_on == toks_off
    assert toks_on == [list(np.asarray(r.wait(), np.int32)) for r in jreqs]
    for i, t in enumerate(toks_on):
        assert t == list(ref[i, :len(t)])
        assert len(t) == GEN or (i == 0 and t[-1] == eos)
    assert len(toks_on[0]) < GEN, "the EOS never fired"
    assert off["spec"] == "off" and off["spec_drafted"] == 0
    assert on["spec"] == "ngram" and on["spec_k"] == 3
    assert on["spec_drafted"] > 0 and on["spec_accepted"] > 0
    assert 0.0 < on["spec_accept_rate"] <= 1.0
    assert on["dispatches_per_token"] < off["dispatches_per_token"]
    assert on["decode_dispatches"] < off["decode_dispatches"]
    for key in ("spec_drafted", "spec_accepted", "spec_rollbacks",
                "decode_dispatches", "decode_tokens", "tokens_out"):
        assert on[key] == jstats[key], key


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_dense_spec_engine_equals_the_oneshot_tokens(arch, built):
    """A dense engine (``page_size=None``): the windows go through
    ``_cache_update_window``, masked lanes included, and the tokens are
    the one-shot tokens."""
    b = _build(arch, built)
    stats, toks = _engine(b, _reqs(b, b["motif"]), page_size=None,
                          spec="ngram", spec_k=3)
    assert toks == [list(r) for r in b["motif_ref"]]
    assert stats["spec_drafted"] > stats["spec_accepted"] > 0
    assert stats["page_size"] is None


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_spec_stays_exact_under_fuzz_evictions(arch, built):
    """Forced evictions on top of on-demand growth (page size 2 < the
    window): spec-on tokens equal the port's spec-off leg under the same
    policy and the one-shot tokens; restores = evictions > 0 (a vision
    restore replays its patches on the replay's first chunk)."""
    b = _build(arch, built)
    legs = {}
    for spec in ("off", "ngram"):
        legs[spec] = _engine(b, _reqs(b, b["motif"]), page_size=2,
                             paged_kernel=True,
                             policy=OnDemandFuzzEvict(seed=7), spec=spec,
                             spec_k=3)
    stats, toks = legs["ngram"]
    assert toks == legs["off"][1]
    assert toks == [list(r) for r in b["motif_ref"]]
    assert stats["evictions"] > 0
    assert stats["restores"] == stats["evictions"]
    assert stats["spec_drafted"] > 0
    assert stats["restore_divergences"] == 0


def test_vision_spec_on_equals_spec_off_and_skips_the_trie(built):
    """internvl2-2b with the paged kernel and the prefix cache on: spec-on
    tokens equal the spec-off leg's and the one-shot tokens, spec drafts
    and spends fewer dispatches per token, and no vision request looks up
    or enters the trie (its key lacks the patches).  One slot, as in the
    text families' test."""
    b = _build("internvl2-2b", built)
    kw = dict(slots=1, page_size=4, paged_kernel=True, prefix_cache="on",
              spec_k=3)
    off, toks_off = _engine(b, _reqs(b, b["motif"]), **kw)
    on, toks_on = _engine(b, _reqs(b, b["motif"]), spec="ngram", **kw)
    assert toks_on == toks_off == [list(r) for r in b["motif_ref"]]
    assert on["spec_drafted"] > 0 and on["spec_accepted"] > 0
    assert on["dispatches_per_token"] < off["dispatches_per_token"]
    for st in (off, on):
        assert st["prefix_cache"] is True
        assert st["prefix_lookups"] == 0 == st["prefix_inserted_pages"]


def test_audio_refuses_spec_and_eos_stop_as_the_reference():
    """musicgen-large emits a codebook vector a step: both engines refuse
    speculation at construction and eos/stop per request, with the same
    errors, and serve the plain request beside them alike."""
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine

    cfg = get("musicgen-large").tiny()
    jp = jax_init_params(cfg, jax.random.PRNGKey(0))
    legs = {"port": (ServeEngine, Request, dict(device="cpu"),
                     params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                       "cpu")),
            "reference": (JServeEngine, JRequest, {}, jp)}
    prompts, _ = frontend_inputs(cfg, 3, PLEN)
    got = {}
    for leg, (eng_cls, req_cls, kw, params) in legs.items():
        with pytest.raises(ValueError, match="speculative decoding") as e:
            eng_cls(cfg, lambda: None, cache_len=CACHE_LEN, spec="ngram",
                    **kw)
        out = [str(e.value)]
        reqs = [req_cls(0, prompts[0], max_new_tokens=4, eos_id=3),
                req_cls(1, prompts[1], max_new_tokens=4, stop=[[3, 4]]),
                req_cls(2, prompts[2], max_new_tokens=4)]
        eng = eng_cls(cfg, params, slots=2, cache_len=CACHE_LEN, n_cores=4,
                      **kw).start()
        for r in reqs:
            eng.submit(r)
        drain(eng, reqs, TIMEOUT_S)
        for r in reqs[:2]:
            with pytest.raises(ValueError, match="eos_id/stop are not "
                               "supported for audio-codebook frontends"):
                r.wait()
            out.append(str(r.error))
        out.append(np.asarray(reqs[2].wait()).tolist())
        got[leg] = out
    assert got["port"] == got["reference"]


class OracleDrafter(Drafter):
    """Drafts each stream's true continuation (the one-shot row found by
    matching the context), so every window is full and accepted."""

    name = "oracle"

    def __init__(self, prompts, ref):
        self.streams = [list(map(int, p)) + list(map(int, r))
                        for p, r in zip(prompts, ref)]

    def draft(self, ctx, k):
        for s in self.streams:
            if len(ctx) <= len(s) and s[:len(ctx)] == ctx:
                return s[len(ctx):len(ctx) + k]
        return []


class OraclePolicy(OnDemandPolicy):
    """On-demand policy whose drafter is the oracle: the drafter is a
    policy choice (``spec_drafter``), so the engine is not touched."""

    def __init__(self, drafter):
        self._drafter = drafter

    def spec_drafter(self, eng, mode):
        return self._drafter


def test_oracle_windows_grow_several_pages_in_a_tight_pool(built):
    """spec_k 5 >= page size 2: one window crosses several pages, so the
    fault pass grows a slot by more than one page in one tick, and a pool
    two pages above one request's worst case evicts; every oracle draft
    is accepted and the tokens are the one-shot tokens."""
    b = _build("qwen2.5-14b", built)
    worst = -(-(PLEN + GEN - 1) // 2)
    stats, toks = _engine(
        b, [Request(i, b["prompts"][i], max_new_tokens=GEN)
            for i in range(N_REQ)],
        page_size=2, num_pages=worst + 2, spec="oracle", spec_k=5,
        policy=OraclePolicy(OracleDrafter(b["prompts"], b["ref"])))
    assert toks == [list(r) for r in b["ref"]]
    assert stats["spec_drafted"] > 0
    assert stats["spec_accepted"] == stats["spec_drafted"]
    assert stats["spec_rollbacks"] == 0
    assert stats["pages_grown_multi"] > 0
    assert stats["evictions"] > 0
    assert stats["restores"] == stats["evictions"]


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_over_a_warm_prefix_trie(arch, built):
    """Every prompt shares its first 6 tokens with request 0, served first
    so its pages are in the trie: the hits' windows never write a shared
    or cached page (the engine checks every window under the prefix
    cache, and raises), and the tokens equal the cold one-shot run."""
    import time

    b = _build(arch, built)
    prompts = b["motif"].copy()
    prompts[1:, :6] = prompts[0, :6]
    ref = greedy_oneshot(b["prefill"], make_serve_step(b["cfg"]),
                         b["params"], torch.tensor(prompts), None,
                         GEN).numpy()
    reqs = [Request(i, prompts[i], max_new_tokens=GEN) for i in range(N_REQ)]
    eng = ServeEngine(b["cfg"], b["params"], slots=SLOTS, cache_len=CACHE_LEN,
                      n_cores=4, page_size=2, paged_kernel=True,
                      prefix_cache="on", spec="ngram", spec_k=3,
                      device="cpu").start()
    checked = []
    check = eng._check_window_private
    eng._check_window_private = lambda live, d: (checked.append(len(live)),
                                                 check(live, d))
    eng.submit(reqs[0])
    assert reqs[0].done.wait(TIMEOUT_S)
    for r in reqs[1:]:
        eng.submit(r)
        time.sleep(0.002)
    stats = drain(eng, reqs, TIMEOUT_S)
    assert [list(np.asarray(r.wait(), np.int32)) for r in reqs] == \
        [list(r) for r in ref]
    assert stats["prefix_hits"] >= 1 and stats["prefix_tokens_saved"] > 0
    assert stats["spec_drafted"] > 0
    assert len(checked) == stats["ticks"] > 0
    assert eng.pager.live_refs == 0


def test_a_window_onto_a_shared_page_is_refused(built):
    """The write-privacy check itself: a slot whose next window would
    write a page the trie holds raises before the dispatch."""
    b = _build("qwen2.5-14b", built)
    eng = ServeEngine(b["cfg"], b["params"], slots=SLOTS, cache_len=CACHE_LEN,
                      page_size=2, prefix_cache="on", spec="ngram",
                      device="cpu")
    try:
        ids = eng.pager.alloc(2)
        eng.kv.bind_slot_pages(0, ids)
        eng._slot_pos[0] = 2                    # writes page ids[1]
        eng._check_window_private([0], {0: [5]})
        eng.pager.share([ids[1]])               # a second holder
        with pytest.raises(RuntimeError, match="shared or cached"):
            eng._check_window_private([0], {0: [5]})
    finally:
        eng.shutdown()


def test_a_failing_verify_fails_the_request_without_fallback(built):
    """No fallback: a verify dispatch that raises fails the live request
    with that error; the plain decode tick never runs."""
    b = _build("qwen2.5-14b", built)
    eng = ServeEngine(b["cfg"], b["params"], slots=SLOTS, cache_len=CACHE_LEN,
                      n_cores=4, page_size=4, spec="ngram", device="cpu")
    decoded = []

    def broken(*a, **kw):
        raise RuntimeError("verify dispatch failed")
    eng.verify = broken
    eng.decode = lambda *a, **kw: decoded.append(1)
    eng.start()
    req = Request(0, b["prompts"][0], max_new_tokens=GEN)
    eng.submit(req)
    assert req.done.wait(TIMEOUT_S)
    with pytest.raises(RuntimeError, match="verify dispatch failed"):
        req.wait()
    assert decoded == []
    eng.close()
    with pytest.raises(RuntimeError, match="verify dispatch failed"):
        eng.join()                      # the decode task's own failure
    eng.rt.shutdown()


# ---------------------------------------------------------------------- CLI
def test_cli_spec_ngram_prints_spec_keys_and_spec_off_tokens(capsys):
    """``--spec ngram`` on the CPU: the JSON line carries the spec keys,
    and its sample tokens equal ``--spec off``'s."""
    from repro_torch.launch.serve import serve

    rows = {}
    for spec in ("off", "ngram"):
        serve(["--tiny", "--device", "cpu", "--batch", "2", "--requests",
               "3", "--prompt-len", "8", "--gen", "6", "--cores", "3",
               "--spec", spec, "--spec-k", "3"])
        rows[spec] = json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1])
    for key in ("spec", "spec_drafted", "spec_accepted", "spec_rollbacks",
                "spec_accept_rate", "decode_dispatches",
                "dispatches_per_token"):
        assert key in rows["ngram"], key
    assert rows["ngram"]["spec"] == "ngram" and rows["off"]["spec"] == "off"
    assert rows["ngram"]["sample"] == rows["off"]["sample"]
    assert rows["ngram"]["generated_shape"] == [3, 6]
