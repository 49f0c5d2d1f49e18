"""The two modality frontends in the port against the reference, on the
tiny f32 configs of internvl2-2b (``vision_patches``: precomputed patch
embeddings in front of the text) and musicgen-large
(``audio_codebooks``: K parallel codebook streams, summed embeddings, K
LM heads, sinusoidal positions and no rope).  Weights come from the
reference's ``init_params`` through ``repro_torch.params``; tokens and
patches from a numpy seed.

Covered: ``sinusoidal_pos``, ``embed_tokens`` and ``lm_logits``;
``params_from_numpy`` on both families; ``forward`` in "train",
"prefill" + "decode" (per-slot and scalar positions) and
"prefill_chunk" (the patches on the first chunk only; chunk lengths that
split the prompt evenly and that do not); internvl2-2b's "verify";
``greedy_oneshot`` tokens; one train step against the reference's
``make_train_step`` (``tests/test_torch_train.py``'s check: loss,
gradient norm, the updated params, m and v), with the patches in the
microbatch for vision and (B, S, K) labels for audio.

Tolerances: ``sinusoidal_pos`` by the angle's rounding (its test says
how); the embedding and the head rtol 1e-6 / atol 1e-6 (one f32 sum or
product each); logits and cache leaves
rtol 1e-4 / atol 1e-5, the model tests' bound (XLA:CPU and PyTorch's CPU
GEMMs sum in other orders, and the difference grows through the layers);
the train step's as ``tests/test_torch_train.py`` states them.  Greedy
tokens are held exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.configs import get
from repro.data import batch_for_step
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import steps as tsteps
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.layers import tree_leaves
from repro_torch.params import params_from_numpy
from test_torch_train import check_step_against_reference

ARCHS = ["internvl2-2b", "musicgen-large"]
LAYER_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
B, PLEN, GEN = 3, 12, 8


def _cache_len(cfg):
    return PLEN + GEN + (cfg.n_patches
                         if cfg.frontend == "vision_patches" else 0)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get(request.param).tiny()
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(1)
    shp = (B, PLEN) + ((cfg.n_codebooks,)
                       if cfg.frontend == "audio_codebooks" else ())
    toks = rng.integers(0, cfg.vocab, shp).astype(np.int32)
    patches = None
    if cfg.frontend == "vision_patches":
        patches = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return dict(cfg=cfg, jp=jp, tp=tp, toks=toks, patches=patches)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.tensor(x)


def _blocks_close(tcache, jcache):
    jl = jax.tree.leaves(jcache["blocks"])
    tl = tree_leaves(tcache["blocks"])
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        _close(t, j)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("shape,top", [((), 40), ((7,), 40), ((3, 1), 40),
                                       ((2, 5), 40), ((16, 1), 2400)])
def test_sinusoidal_pos_matches(shape, top):
    """Positions below ``top`` (40: the tiny models'; 2400: the card's
    vision prompts).  XLA's and PyTorch's f32 ``exp`` may differ by an
    ulp of a frequency (2^-23 relative), which moves an angle by up to
    ``top`` x 2^-23 rad; ``sin`` and ``cos`` add an ulp of their own."""
    pos = np.random.default_rng(0).integers(0, top, shape).astype(np.int32)
    want = jlayers.sinusoidal_pos(jnp.asarray(pos), 64)
    got = tlayers.sinusoidal_pos(torch.tensor(pos), 64)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape + (64,)
    _close(got, want, dict(rtol=0, atol=(top + 2) * 2.0 ** -23))


def test_embed_tokens_and_lm_logits_match(model):
    cfg, jp, tp, toks = (model[k] for k in ("cfg", "jp", "tp", "toks"))
    want = jlayers.embed_tokens(jnp.asarray(toks), jp["embed"], cfg,
                                jnp.float32)
    got = tlayers.embed_tokens(torch.tensor(toks), tp["embed"], cfg,
                               torch.float32)
    assert tuple(got.shape) == (B, PLEN, cfg.d_model)
    _close(got, want, LAYER_TOL)
    x = np.random.default_rng(2).standard_normal(
        (B, PLEN, cfg.d_model)).astype(np.float32)
    want = jlayers.lm_logits(jnp.asarray(x), jp, cfg)
    got = tlayers.lm_logits(torch.tensor(x), tp, cfg)
    k = (cfg.n_codebooks,) if cfg.frontend == "audio_codebooks" else ()
    assert tuple(got.shape) == (B, PLEN) + k + (cfg.vocab,)
    _close(got, want, LAYER_TOL)


def test_audio_embedding_sums_every_codebook():
    """Each codebook's table adds its own row: changing one stream's id
    moves the embedding by exactly that table's difference."""
    cfg = get("musicgen-large").tiny()
    tp = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 1, cfg.n_codebooks), dtype=torch.int32)
    base = tlayers.embed_tokens(toks, tp["embed"], cfg, torch.float32)
    for k in range(cfg.n_codebooks):
        t = toks.clone()
        t[..., k] = 5
        got = tlayers.embed_tokens(t, tp["embed"], cfg, torch.float32)
        want = base + tp["embed"]["tok"][k, 5] - tp["embed"]["tok"][k, 0]
        torch.testing.assert_close(got, want)


def test_params_from_numpy_carries_the_frontend_leaves(model):
    cfg, jp, tp = model["cfg"], model["jp"], model["tp"]
    jl, tl = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    d, v = cfg.d_model, cfg.vocab
    if cfg.frontend == "audio_codebooks":
        k = cfg.n_codebooks
        assert tuple(tp["embed"]["tok"].shape) == (k, v, d)
        assert tuple(tp["lm_head"].shape) == (k, d, v)
    else:
        assert tuple(tp["embed"]["tok"].shape) == (v, d)
        assert tuple(tp["lm_head"].shape) == (d, v)
    seeded = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), jp) == \
        jax.tree.map(lambda x: tuple(x.shape), seeded)


# ----------------------------------------------------------------- forward
def test_train_logits_match(model):
    cfg, jp, tp, toks, pt = (model[k] for k in ("cfg", "jp", "tp", "toks",
                                                "patches"))
    want = jlm.forward(jp, cfg, jnp.asarray(toks), mode="train",
                       patches=_j(pt))["logits"]
    got = tlm.forward(tp, cfg, torch.tensor(toks), mode="train",
                      patches=_t(pt))["logits"]
    assert got.shape[1] == PLEN        # the patch positions are dropped
    _close(got, want)


def test_vision_forward_needs_its_patches():
    cfg = get("internvl2-2b").tiny()
    tp = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for mode in ("train", "prefill"):
        with pytest.raises(ValueError, match="patch embeddings"):
            tlm.forward(tp, cfg, torch.zeros((1, 4), dtype=torch.int32),
                        mode=mode, cache_len=16)


def _prefill(model):
    cfg, jp, tp, toks, pt = (model[k] for k in ("cfg", "jp", "tp", "toks",
                                                "patches"))
    cl = _cache_len(cfg)
    jo = jlm.forward(jp, cfg, jnp.asarray(toks), mode="prefill",
                     patches=_j(pt), cache_len=cl)
    to = tlm.forward(tp, cfg, torch.tensor(toks), mode="prefill",
                     patches=_t(pt), cache_len=cl)
    return jo, to


def test_prefill_and_decode_logits_match(model):
    cfg, jp, tp = model["cfg"], model["jp"], model["tp"]
    jo, to = _prefill(model)
    _close(to["logits"], jo["logits"])
    _blocks_close(to["cache"], jo["cache"])
    n = PLEN + (cfg.n_patches if model["patches"] is not None else 0)
    assert int(to["cache"]["pos"]) == n
    # decode at per-slot positions (continuous batching), then at a
    # scalar: the sinusoid of each row's own position
    nxt = np.asarray(jnp.argmax(jo["logits"], -1)).astype(np.int32)
    for pos in (np.array([n, n - 3, n + 2], np.int32), np.int32(n)):
        jc = dict(jo["cache"], pos=jnp.asarray(pos))
        tc = dict(to["cache"], pos=torch.tensor(pos),
                  blocks=tuple({k: v.clone() for k, v in b.items()}
                               for b in to["cache"]["blocks"]))
        jd = jlm.forward(jp, cfg, jnp.asarray(nxt), mode="decode",
                         pos=jc["pos"], cache=jc)
        td = tlm.forward(tp, cfg, torch.tensor(nxt), mode="decode",
                         pos=tc["pos"], cache=tc)
        _close(td["logits"], jd["logits"])
        _blocks_close(td["cache"], jd["cache"])


@pytest.mark.parametrize("chunk", [4, 5])
def test_prefill_chunks_match_the_reference_and_one_shot(model, chunk):
    """Chunks of 4 split the 12 prompt tokens evenly, chunks of 5 do
    not; a vision prompt's patches ride the first chunk only, and later
    chunks continue past them.  Both packages chunk alike; the last
    chunk's logits and the row cache equal the one-shot prefill's."""
    cfg, jp, tp, toks, pt = (model[k] for k in ("cfg", "jp", "tp", "toks",
                                                "patches"))
    cl = _cache_len(cfg)
    jc = jlm.init_cache(cfg, B, cl, jnp.float32)
    tc = tlm.init_cache(cfg, B, cl, torch.float32, "cpu")
    off = 0
    for c0 in range(0, PLEN, chunk):
        c1 = min(c0 + chunk, PLEN)
        first = c0 == 0
        jo = jlm.forward(jp, cfg, jnp.asarray(toks[:, c0:c1]),
                         mode="prefill_chunk", pos=off, cache=jc,
                         patches=_j(pt) if first else None, cache_len=cl)
        to = tlm.forward(tp, cfg, torch.tensor(toks[:, c0:c1]),
                         mode="prefill_chunk", pos=off, cache=tc,
                         patches=_t(pt) if first else None, cache_len=cl)
        _close(to["logits"], jo["logits"])
        off += (c1 - c0) + (cfg.n_patches if first and pt is not None
                            else 0)
        assert int(to["cache"]["pos"]) == int(jo["cache"]["pos"]) == off
        jc, tc = jo["cache"], to["cache"]
    _blocks_close(tc, jc)
    jw, tw = _prefill(model)
    _close(to["logits"], tw["logits"].numpy())
    for t, w in zip(tree_leaves(tc["blocks"]), tree_leaves(tw["cache"][
            "blocks"])):
        _close(t, w.numpy())


def test_vision_verify_matches_the_reference():
    """The verify window over a vision prompt's prefilled rows: a full
    window, a short one (masked lanes) and a dead slot.  Argmaxes equal,
    logits of the valid lanes within ``TOL``."""
    from repro.steps import make_verify_step as j_make_verify_step

    cfg = get("internvl2-2b").tiny()
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(3)
    cl = _cache_len(cfg)
    toks = rng.integers(0, cfg.vocab, (B, PLEN)).astype(np.int32)
    pt = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(
        np.float32)
    jo = jlm.forward(jp, cfg, jnp.asarray(toks), mode="prefill",
                     patches=jnp.asarray(pt), cache_len=cl)
    to = tlm.forward(tp, cfg, torch.tensor(toks), mode="prefill",
                     patches=torch.tensor(pt), cache_len=cl)
    s, n = 4, PLEN + cfg.n_patches
    pos = np.array([n, n, n], np.int32)
    n_tok = np.array([s, 2, 0], np.int32)
    win = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    jcache = dict(jo["cache"], pos=jnp.asarray(pos))
    tcache = dict(to["cache"], pos=torch.tensor(pos))
    jarg, _ = j_make_verify_step(cfg, cache_len=cl)(
        jp, jcache, jnp.asarray(win), jnp.asarray(pos), jnp.asarray(n_tok))
    targ, _ = tsteps.make_verify_step(cfg, cache_len=cl)(
        tp, tcache, torch.tensor(win), torch.tensor(pos),
        torch.tensor(n_tok))
    for b in range(2):                  # the dead slot's lanes are unread
        np.testing.assert_array_equal(targ[b, :n_tok[b]].numpy(),
                                      np.asarray(jarg)[b, :n_tok[b]])


def test_greedy_oneshot_tokens_match(model):
    cfg, jp, tp, toks, pt = (model[k] for k in ("cfg", "jp", "tp", "toks",
                                                "patches"))
    cl = _cache_len(cfg)
    want = jsteps.greedy_oneshot(
        jax.jit(jsteps.make_prefill_step(cfg, None, cache_len=cl)),
        jax.jit(jsteps.make_serve_step(cfg, None)), jp, jnp.asarray(toks),
        _j(pt), GEN)
    got = tsteps.greedy_oneshot(
        tsteps.make_prefill_step(cfg, cache_len=cl),
        tsteps.make_serve_step(cfg), tp, torch.tensor(toks), _t(pt), GEN)
    assert tuple(got.shape) == tuple(want.shape) == (B, GEN) + toks.shape[2:]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------- training
def test_train_step_matches_the_reference(model):
    """One step from the same state on the same batch (the bars of
    ``tests/test_torch_train.py``): patches in each microbatch for
    vision, (accum, micro, S, K) tokens and labels for audio."""
    cfg = model["cfg"]
    audio = cfg.frontend == "audio_codebooks"
    batch = batch_for_step(0, seed=11, batch=4, seq=16, vocab=cfg.vocab,
                           accum=2, extra_dim=cfg.n_codebooks if audio
                           else 0)
    if cfg.frontend == "vision_patches":
        batch["patches"] = np.random.default_rng(4).standard_normal(
            (2, 2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    check_step_against_reference(cfg.name.removesuffix("-tiny"), batch)
