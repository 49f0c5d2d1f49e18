"""Port model (``repro_torch.models.lm`` + ``repro_torch.steps``) vs the
reference ``repro.models.lm`` / ``repro.steps`` on the tiny qwen2.5-14b
config in f32, weights from the reference's ``init_params`` handed over
as numpy through ``repro_torch.params``.

Tolerances: logits rtol 1e-4 / atol 1e-5 — XLA:CPU and PyTorch's CPU
GEMMs sum in different orders, and the difference grows through the
layers.  Greedy tokens must match exactly, except at a step where the
reference's own top-two logit margin is below ``TIE`` (then the two
frameworks' rounding may legitimately pick either token): such steps are
teacher-forced with the reference's token and reported, never decided.
"""
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
from repro_torch.params import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-5)
TIE = 1e-4
B, PLEN, GEN = 3, 12, 16
CACHE_LEN = PLEN + GEN


@pytest.fixture(scope="module")
def model():
    cfg = get("qwen2.5-14b").tiny()
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (B, PLEN)).astype(np.int32)
    return cfg, jp, tp, toks


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_from_numpy_keeps_layout(model):
    cfg, jp, tp, _ = model
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == len(jax.tree.leaves(tp_tree := {
        "embed": tp["embed"], "blocks": tp["blocks"],
        "final_norm": tp["final_norm"], "lm_head": tp["lm_head"]}))
    assert tuple(tp["blocks"][0]["mixer"]["wq"].shape) == (
        cfg.n_repeats, cfg.d_model, cfg.n_heads * cfg.head_dim)
    np.testing.assert_array_equal(
        tp_tree["blocks"][0]["mlp"]["w_up"].numpy(),
        np.asarray(jp["blocks"][0]["mlp"]["w_up"]))
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(np.asarray, jp)
        bad["final_norm"] = np.ones(3, np.float32)
        params_from_numpy(bad, cfg, device="cpu")


def test_seeded_init_matches_reference_layout(model):
    cfg, jp, _, _ = model
    tp = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(lambda x: tuple(x.shape), jp)
    assert jax.tree.map(lambda x: tuple(x.shape), tp) == shapes
    mix = tp["blocks"][0]["mixer"]
    assert torch.equal(mix["bq"], torch.zeros_like(mix["bq"]))
    assert torch.equal(mix["ln"], torch.ones_like(mix["ln"]))
    assert abs(mix["wq"].std().item() - 0.02) < 2e-3


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
    for jl, tl in zip(jax.tree.leaves(jo["cache"]["blocks"]),
                      [to["cache"]["blocks"][0][k] for k in ("k", "v")]):
        _close(tl, jl)
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
        _close(td["cache"]["blocks"][0]["k"], jd["cache"]["blocks"][0]["k"])
        np.testing.assert_array_equal(td["cache"]["pos"].numpy(),
                                      np.asarray(jd["cache"]["pos"]))


def test_modes_outside_the_slice_raise(model):
    cfg, _, tp, toks = model
    for mode in ("verify", "prefill_chunk"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tlm.forward(tp, cfg, torch.tensor(toks), mode=mode)
    for arch in ("minicpm3-4b", "mamba2-780m", "mixtral-8x7b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tlm.param_meta(get(arch).tiny())


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
