"""Port model (``repro_torch.models.lm`` + ``repro_torch.steps``) vs the
reference ``repro.models.lm`` / ``repro.steps`` on the tiny configs of
the ported families in f32 — qwen2.5-14b (GQA), minicpm3-4b (MLA),
mamba2-780m (SSD) and mixtral-8x7b (GQA + MoE; jamba-v0.1-52b, the
hybrid, in its own test) — weights from the reference's ``init_params``
handed over as numpy through ``repro_torch.params``.

The sliding-window ring: the port places position p in ring slot
p % ring after a prefill longer than the ring, as decode reads and writes
it; the reference keeps the last ``ring`` positions unrolled, which is the
same only when the prompt length is a multiple of the ring.  The port is
held to the reference at such lengths and to its own train-mode forward
(the true window mask) at every length.

Tolerances: logits rtol 1e-4 / atol 1e-5 — XLA:CPU and PyTorch's CPU
GEMMs sum in different orders, and the difference grows through the
layers.  Greedy tokens must match exactly, except at a step where the
reference's own top-two logit margin is below ``TIE`` (then the two
frameworks' rounding may legitimately pick either token): such steps are
teacher-forced with the reference's token and reported, never decided.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.configs import get
from repro.models import lm as jlm
from repro_torch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models.layers import tree_leaves
from repro_torch.params import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-5)
TIE = 1e-4
B, PLEN, GEN = 3, 12, 16
CACHE_LEN = PLEN + GEN
ARCHS = ["qwen2.5-14b", "minicpm3-4b", "mamba2-780m", "mixtral-8x7b"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get(request.param).tiny()
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (B, PLEN)).astype(np.int32)
    return cfg, jp, tp, toks


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_from_numpy_keeps_layout(model):
    cfg, jp, tp, _ = model
    jl, tl = jax.tree.leaves(jp), tree_leaves(tp)   # both by sorted keys
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if "wq" in tp["blocks"][0]["mixer"]:
        assert tuple(tp["blocks"][0]["mixer"]["wq"].shape) == (
            cfg.n_repeats, cfg.d_model, cfg.n_heads * cfg.head_dim)
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(np.asarray, jp)
        bad["final_norm"] = np.ones(3, np.float32)
        params_from_numpy(bad, cfg, device="cpu")


def test_seeded_init_matches_reference_layout(model):
    cfg, jp, _, _ = model
    tp = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(lambda x: tuple(x.shape), jp)
    assert jax.tree.map(lambda x: tuple(x.shape), tp) == shapes
    mix, jmix = tp["blocks"][0]["mixer"], jp["blocks"][0]["mixer"]
    assert torch.equal(mix["ln"], torch.ones_like(mix["ln"]))
    if cfg.qkv_bias:
        assert torch.equal(mix["bq"], torch.zeros_like(mix["bq"]))
    for name in ("A_log", "dt_bias"):         # fixed ramps, not random
        if name in mix:
            np.testing.assert_allclose(mix[name].numpy(),
                                       np.asarray(jmix[name]), rtol=1e-6)
    big = max((v for v in mix.values() if v.dim() == 3),
              key=lambda v: v.numel())
    assert abs(big.std().item() - 0.02) < 2e-3


def test_train_logits_match(model):
    cfg, jp, tp, toks = model
    want = jlm.forward(jp, cfg, jnp.asarray(toks), mode="train")["logits"]
    got = tlm.forward(tp, cfg, torch.tensor(toks), mode="train")["logits"]
    _close(got, want)


def test_prefill_and_decode_logits_match(model):
    cfg, jp, tp, toks = model
    jo = jlm.forward(jp, cfg, jnp.asarray(toks), mode="prefill",
                     cache_len=CACHE_LEN)
    to = tlm.forward(tp, cfg, torch.tensor(toks), mode="prefill",
                     cache_len=CACHE_LEN)
    _close(to["logits"], jo["logits"])
    jl = jax.tree.leaves(jo["cache"]["blocks"])
    tl = tree_leaves(to["cache"]["blocks"])
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        _close(t, j)
    assert int(to["cache"]["pos"]) == PLEN
    # decode at per-slot positions (continuous batching) and at a scalar
    nxt = np.asarray(jnp.argmax(jo["logits"], -1)).astype(np.int32)
    for pos in (np.full((B,), PLEN, np.int32), np.int32(PLEN)):
        jc = dict(jo["cache"], pos=jnp.asarray(pos))
        tc = dict(to["cache"], pos=torch.tensor(pos),
                  blocks=tuple({k: v.clone() for k, v in b.items()}
                               for b in to["cache"]["blocks"]))
        jd = jlm.forward(jp, cfg, jnp.asarray(nxt), mode="decode",
                         pos=jc["pos"], cache=jc)
        td = tlm.forward(tp, cfg, torch.tensor(nxt), mode="decode",
                         pos=tc["pos"], cache=tc)
        _close(td["logits"], jd["logits"])
        for j, t in zip(jax.tree.leaves(jd["cache"]["blocks"]),
                        tree_leaves(td["cache"]["blocks"])):
            _close(t, j)
        np.testing.assert_array_equal(td["cache"]["pos"].numpy(),
                                      np.asarray(jd["cache"]["pos"]))


def test_modes_outside_the_slice_raise(model):
    cfg, _, tp, toks = model
    for mode in ("verify", "prefill_chunk"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tlm.forward(tp, cfg, torch.tensor(toks), mode=mode)
    # families still unported: the audio and vision frontends (MoE and the
    # attention + SSD + MoE hybrid are ported: see the jamba test below)
    for arch in ("musicgen-large", "internvl2-2b"):
        c = get(arch).tiny()
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tlm.forward(tlm.init_params(c, torch.Generator().manual_seed(0),
                                        "cpu"),
                        c, torch.zeros((1, 4), dtype=torch.int32))


@pytest.fixture(scope="module")
def jamba():
    cfg = get("jamba-v0.1-52b").tiny()
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (B, PLEN)).astype(np.int32)
    return cfg, jp, tp, toks


@pytest.mark.parametrize("mode", ["train", "prefill_decode"])
def test_jamba_logits_match_reference(jamba, mode):
    """The hybrid (attention + SSD mixers, dense and MoE MLPs) runs
    through the ported modules: train logits, prefill logits, and two
    decode steps, against the reference.  (Were a jamba-specific piece
    still missing, the port would raise NotImplementedError naming its
    ROADMAP item here.)"""
    cfg, jp, tp, toks = jamba
    if mode == "train":
        jo = jlm.forward(jp, cfg, jnp.asarray(toks), mode="train")
        to = tlm.forward(tp, cfg, torch.tensor(toks), mode="train")
        _close(to["logits"], jo["logits"])
        return
    jo = jlm.forward(jp, cfg, jnp.asarray(toks), mode="prefill",
                     cache_len=CACHE_LEN)
    to = tlm.forward(tp, cfg, torch.tensor(toks), mode="prefill",
                     cache_len=CACHE_LEN)
    _close(to["logits"], jo["logits"])
    jc, tc = jo["cache"], to["cache"]
    nxt = np.asarray(jnp.argmax(jo["logits"], -1)).astype(np.int32)
    for _ in range(2):
        jd = jlm.forward(jp, cfg, jnp.asarray(nxt), mode="decode",
                         pos=jc["pos"], cache=jc)
        td = tlm.forward(tp, cfg, torch.tensor(nxt), mode="decode",
                         pos=tc["pos"], cache=tc)
        _close(td["logits"], jd["logits"])
        jc, tc = jd["cache"], td["cache"]
        nxt = np.asarray(jnp.argmax(jd["logits"], -1)).astype(np.int32)


# ------------------------------------------------------- sliding-window ring
RING, RING_CACHE, RING_STEPS = 8, 32, 3


@pytest.fixture(scope="module")
def ring_model():
    """mixtral's tiny config with its pattern's window cut to 8, so that
    prompts pass the window (the full config's 4096 never is at tiny
    lengths), and the dropless MoE dispatch: with capacity dispatch the
    train forward over a longer sequence drops other picks than prefill
    and decode do (4 tiny experts overflow often), a difference that is
    not the ring's."""
    base = get("mixtral-8x7b").tiny()
    cfg = base.replace(moe_impl="ragged", pattern=(dataclasses.replace(
        base.pattern[0], window=RING),))
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jp, tp


def _ring_run(cfg, tp, toks, unroll=False):
    """Port prefill of ``toks`` then RING_STEPS greedy decode steps; the
    logits of each step and the fed tokens.  ``unroll`` puts the ring
    back the way the reference leaves it (the last ``ring`` positions in
    order) before decoding."""
    s = toks.shape[1]
    out = tlm.forward(tp, cfg, torch.tensor(toks), mode="prefill",
                      cache_len=RING_CACHE)
    cache = out["cache"]
    if unroll and s >= RING:
        for blk in cache["blocks"]:
            for name in ("k", "v"):
                blk[name] = torch.roll(blk[name], -(s % RING), dims=2)
    logits, fed = [out["logits"][:, -1]], []
    for _ in range(RING_STEPS):
        nxt = logits[-1].argmax(-1, keepdim=True).int()
        fed.append(nxt)
        d = tlm.forward(tp, cfg, nxt, mode="decode", pos=cache["pos"],
                        cache=cache)
        cache = d["cache"]
        logits.append(d["logits"][:, -1])
    return torch.stack(logits, 1), torch.cat(fed, 1)


def _train_logits(cfg, tp, toks, fed):
    """The port's train-mode forward (full attention, true window mask)
    over prompt + fed tokens: the logits at the last RING_STEPS + 1
    positions."""
    seq = torch.cat([torch.tensor(toks), fed], dim=1)
    lg = tlm.forward(tp, cfg, seq, mode="train")["logits"]
    return lg[:, toks.shape[1] - 1:]


@pytest.mark.parametrize("s", [5, 8, 12, 16, 19])
def test_ring_prefill_then_decode_matches_train_forward(ring_model, s):
    """Prefill past the window (s = 12, 19: not a multiple of it) and
    decode steps give the train forward's logits; putting the ring back
    in the reference's unrolled order breaks that, by as much as an
    unrelated token would."""
    cfg, _, tp = ring_model
    toks = np.random.default_rng(s).integers(
        0, cfg.vocab, (2, s)).astype(np.int32)
    got, fed = _ring_run(cfg, tp, toks)
    want = _train_logits(cfg, tp, toks, fed)
    _close(got, want)
    if s > RING and s % RING:
        old, fed_old = _ring_run(cfg, tp, toks, unroll=True)
        assert torch.equal(fed_old[:, :1], fed[:, :1])
        err = (old[:, 1:] - want[:, 1:]).abs().max().item()
        assert err > 1e-2, f"the unrolled ring went unnoticed ({err:.2e})"


@pytest.mark.parametrize("s", [5, 8, 16])
def test_ring_matches_reference_where_it_is_right(ring_model, s):
    """At s <= ring or s % ring == 0 the reference's placement is right:
    the port's prefill caches and decode logits equal the reference's."""
    cfg, jp, tp = ring_model
    toks = np.random.default_rng(s).integers(
        0, cfg.vocab, (2, s)).astype(np.int32)
    jo = jlm.forward(jp, cfg, jnp.asarray(toks), mode="prefill",
                     cache_len=RING_CACHE)
    to = tlm.forward(tp, cfg, torch.tensor(toks), mode="prefill",
                     cache_len=RING_CACHE)
    _close(to["logits"], jo["logits"])
    for j, t in zip(jax.tree.leaves(jo["cache"]["blocks"]),
                    tree_leaves(to["cache"]["blocks"])):
        _close(t, j)
    jc, tc = jo["cache"], to["cache"]
    nxt = np.asarray(jnp.argmax(jo["logits"], -1)).astype(np.int32)
    for _ in range(RING_STEPS):
        jd = jlm.forward(jp, cfg, jnp.asarray(nxt), mode="decode",
                         pos=jc["pos"], cache=jc)
        td = tlm.forward(tp, cfg, torch.tensor(nxt), mode="decode",
                         pos=tc["pos"], cache=tc)
        _close(td["logits"], jd["logits"])
        jc, tc = jd["cache"], td["cache"]
        nxt = np.asarray(jnp.argmax(jd["logits"], -1)).astype(np.int32)


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_paged_decode_logits_match_reference(model, paged_kernel):
    """Paged decode (gather leg, and the kernel leg through its plain
    version on the CPU) against the reference's dense decode at per-slot
    positions: same logits, tick after tick."""
    cfg, jp, tp, toks = model
    ps = 4
    jo = jlm.forward(jp, cfg, jnp.asarray(toks), mode="prefill",
                     cache_len=CACHE_LEN)
    rows, _ = tsteps.make_prefill_step(cfg, cache_len=CACHE_LEN)(
        tp, torch.tensor(toks))
    pps = CACHE_LEN // ps
    num_pages = 1 + B * pps
    paged = tsteps.init_paged_slot_cache(cfg, B, CACHE_LEN, torch.float32,
                                         ps, num_pages, "cpu")
    perm = np.random.default_rng(3).permutation(np.arange(1, num_pages))
    table = torch.tensor(perm.reshape(B, pps).astype(np.int32))
    insert = tsteps.make_batched_insert_step(cfg, cache_len=CACHE_LEN,
                                             page_size=ps)
    for i in range(B):
        paged = insert(paged, rows, i, i, table[i])
    pages = {"table": table, "page_size": ps, "cache_len": CACHE_LEN,
             "kernel": paged_kernel}
    jc = dict(jo["cache"], pos=jnp.full((B,), PLEN, jnp.int32))
    nxt = np.asarray(jnp.argmax(jo["logits"], -1)).astype(np.int32)
    for _ in range(4):
        jd = jlm.forward(jp, cfg, jnp.asarray(nxt), mode="decode",
                         pos=jc["pos"], cache=jc)
        td = tlm.forward(tp, cfg, torch.tensor(nxt), mode="decode",
                         pos=paged["pos"], cache=paged, pages=pages)
        _close(td["logits"], jd["logits"])
        jc, paged = jd["cache"], td["cache"]
        nxt = np.asarray(jnp.argmax(jd["logits"], -1)).astype(np.int32)


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_paged_decode_legs_match_dense(model, paged_kernel):
    """Dense per-slot cache vs paged pool (gather leg, and the kernel leg
    through its plain version on the CPU): same logits, same tokens."""
    cfg, _, tp, toks = model
    ps = 4
    prefill = tsteps.make_prefill_step(cfg, cache_len=CACHE_LEN)
    rows, logits = prefill(tp, torch.tensor(toks))
    t0 = logits.argmax(-1).int()
    dt = torch.float32
    dense = tsteps.init_slot_cache(cfg, B, CACHE_LEN, dt, "cpu")
    pps = CACHE_LEN // ps
    num_pages = 1 + B * pps
    paged = tsteps.init_paged_slot_cache(cfg, B, CACHE_LEN, dt, ps,
                                         num_pages, "cpu")
    perm = np.random.default_rng(2).permutation(np.arange(1, num_pages))
    table = torch.tensor(perm.reshape(B, pps).astype(np.int32))
    ins_d = tsteps.make_batched_insert_step(cfg, cache_len=CACHE_LEN)
    ins_p = tsteps.make_batched_insert_step(cfg, cache_len=CACHE_LEN,
                                            page_size=ps)
    for i in range(B):
        dense = ins_d(dense, rows, i, i)
        paged = ins_p(paged, rows, i, i, table[i])
    dec_d = tsteps.make_decode_step(cfg)
    dec_p = tsteps.make_decode_step(cfg, cache_len=CACHE_LEN, page_size=ps,
                                    paged_kernel=paged_kernel)
    active = torch.ones(B, dtype=torch.bool)
    td = tp_ = t0
    for _ in range(GEN - 1):
        td, dense = dec_d(tp, dense, td, active)
        tp_, paged = dec_p(tp, paged, tp_, active, table)
        assert torch.equal(td, tp_)
    assert torch.equal(dense["pos"], paged["pos"])


def _jax_trajectory(cfg, jp, toks):
    """Reference greedy run with its logits: (tokens (B, GEN), top-2
    margins (B, GEN))."""
    dec = jax.jit(lambda p, c, t: jlm.forward(p, cfg, t, mode="decode",
                                              pos=c["pos"], cache=c))
    out = jlm.forward(jp, cfg, jnp.asarray(toks), mode="prefill",
                      cache_len=CACHE_LEN)
    cache, logits = out["cache"], out["logits"]
    tokens, margins = [], []
    for _ in range(GEN):
        lg = np.asarray(logits[:, -1])
        top = np.sort(lg, axis=-1)
        tokens.append(lg.argmax(-1).astype(np.int32))
        margins.append(top[:, -1] - top[:, -2])
        o = dec(jp, cache, jnp.asarray(tokens[-1][:, None]))
        cache, logits = o["cache"], o["logits"]
    return np.stack(tokens, 1), np.stack(margins, 1)


def test_greedy_tokens_match_reference_oneshot(model):
    cfg, jp, tp, toks = model
    ref = np.asarray(jsteps.greedy_oneshot(
        jax.jit(jsteps.make_prefill_step(cfg, cache_len=CACHE_LEN)),
        jax.jit(jsteps.make_serve_step(cfg)), jp, jnp.asarray(toks), None,
        GEN))
    traj, margins = _jax_trajectory(cfg, jp, toks)
    np.testing.assert_array_equal(traj, ref)
    got = tsteps.greedy_oneshot(
        tsteps.make_prefill_step(cfg, cache_len=CACHE_LEN),
        tsteps.make_serve_step(cfg), tp, torch.tensor(toks), None,
        GEN).numpy()
    ties = margins < TIE
    for b in range(B):
        first_tie = int(np.argmax(ties[b])) if ties[b].any() else GEN
        # free-running: exact up to (and including) the first near-tie
        np.testing.assert_array_equal(got[b, :first_tie],
                                      ref[b, :first_tie])
    # teacher-forced with the reference's tokens: every step that is not
    # a near-tie must pick the reference's token
    prefill = tsteps.make_prefill_step(cfg, cache_len=CACHE_LEN)
    cache, logits = prefill(tp, torch.tensor(toks))
    step = tsteps.make_serve_step(cfg)
    for s in range(GEN):
        pick = logits[:, -1].argmax(-1).numpy() if s == 0 else nxt[:, 0]
        ok = (pick == ref[:, s]) | ties[:, s]
        assert ok.all(), f"step {s}: {pick} vs {ref[:, s]}"
        nxt, cache = step(tp, cache, torch.tensor(ref[:, s:s + 1]))
        nxt = nxt.numpy()
    if ties.any():
        print(f"teacher-forced past {int(ties.sum())} near-tie step(s)")
