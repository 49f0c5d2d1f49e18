"""Port layers (``repro_torch.models.layers``) vs their JAX twins in
``repro.models.layers``, f32, same numpy inputs on both sides.

Tolerance rtol = atol = 1e-5 for the matmul-backed functions: XLA:CPU
and PyTorch's CPU GEMMs sum in different orders.  Pure data movement
(gather, scatter, embedding) must match exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get
from repro.models import layers as J
from repro_torch.models import layers as T

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = get("qwen2.5-14b").tiny()


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_rms_norm_matches_jax():
    x = _rng().standard_normal((3, 5, 64), np.float32)
    w = _rng(1).standard_normal(64, np.float32)
    _close(T.rms_norm(torch.tensor(x), torch.tensor(w), 1e-5),
           J.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


def test_gated_rms_norm_matches_jax():
    """Mamba2's norm, rms_norm(x * silu(z)), at mamba2-780m's tiny inner
    width; the gate runs in f32 on both sides."""
    r = _rng(7)
    x = r.standard_normal((2, 5, 128), np.float32)
    z = r.standard_normal((2, 5, 128), np.float32)
    w = r.standard_normal(128, np.float32) * 0.1 + 1.0
    _close(T.gated_rms_norm(torch.tensor(x), torch.tensor(z),
                            torch.tensor(w), 1e-5),
           J.gated_rms_norm(jnp.asarray(x), jnp.asarray(z), jnp.asarray(w),
                            1e-5))


@pytest.mark.parametrize("pos_kind", ["scalar", "seq", "per_slot"])
def test_apply_rope_matches_jax(pos_kind):
    x = _rng().standard_normal((3, 4, 2, 16), np.float32)
    pos = {"scalar": np.int32(7),
           "seq": np.arange(4, dtype=np.int32) + 3,
           "per_slot": np.array([[0], [5], [11]], np.int32)}[pos_kind]
    if pos_kind == "per_slot":
        x = x[:, :1]
    _close(T.apply_rope(torch.tensor(x), torch.tensor(pos), 10_000.0),
           J.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


def test_rope_freqs_identical():
    np.testing.assert_array_equal(T.rope_freqs(128, 1e4),
                                  J.rope_freqs(128, 1e4))


def test_mlp_dense_matches_jax():
    r = _rng(2)
    x = r.standard_normal((2, 3, 64), np.float32)
    p = {k: r.standard_normal(s, np.float32) * 0.1
         for k, s in (("w_gate", (64, 128)), ("w_up", (64, 128)),
                      ("w_down", (128, 64)))}
    _close(T.mlp_dense(torch.tensor(x),
                       {k: torch.tensor(v) for k, v in p.items()}, CFG),
           J.mlp_dense(jnp.asarray(x),
                       {k: jnp.asarray(v) for k, v in p.items()}, CFG))


def test_embed_and_logits_match_jax():
    r = _rng(3)
    emb = r.standard_normal((CFG.vocab, CFG.d_model), np.float32)
    head = r.standard_normal((CFG.d_model, CFG.vocab), np.float32)
    toks = r.integers(0, CFG.vocab, (2, 5)).astype(np.int32)
    e_t = T.embed_tokens(torch.tensor(toks), {"tok": torch.tensor(emb)},
                         CFG, torch.float32)
    e_j = J.embed_tokens(jnp.asarray(toks), {"tok": jnp.asarray(emb)}, CFG,
                         jnp.float32)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    _close(T.lm_logits(e_t, {"lm_head": torch.tensor(head)}, CFG),
           J.lm_logits(e_j, {"lm_head": jnp.asarray(head)}, CFG), rtol=1e-5,
           atol=1e-4)


def test_frontends_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.embed_tokens(torch.zeros(1, 2, 4, dtype=torch.int32), {},
                       get("musicgen-large").tiny(), torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.lm_logits(torch.zeros(1, 1, 64), {}, get("internvl2-2b").tiny())


def _pool_and_table():
    r = _rng(4)
    pool = r.standard_normal((7, 4, 2, 16), np.float32)
    table = np.array([[3, 1, 0], [2, 5, 6]], np.int32)   # page 0 garbage
    return pool, table


def test_page_gather_matches_jax():
    pool, table = _pool_and_table()
    np.testing.assert_array_equal(
        T.page_gather(torch.tensor(pool), torch.tensor(table), 4).numpy(),
        np.asarray(J.page_gather(jnp.asarray(pool), jnp.asarray(table), 4)))


def test_page_scatter_matches_jax_in_place():
    pool, table = _pool_and_table()
    idx = np.array([5, 9], np.int32)
    upd = _rng(5).standard_normal((2, 1, 2, 16), np.float32)
    want = J.page_scatter(jnp.asarray(pool), jnp.asarray(table), 4,
                          jnp.asarray(idx), jnp.asarray(upd))
    tp = torch.tensor(pool)
    got = T.page_scatter(tp, torch.tensor(table), 4, torch.tensor(idx),
                         torch.tensor(upd))
    assert got is tp                      # updated in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_check_cache_invariant_guards_shape_and_dtype():
    old = {"k": torch.zeros(2, 3), "v": torch.zeros(2, 3)}
    assert T.check_cache_invariant(old, dict(old)) is not None
    with pytest.raises(RuntimeError, match="contract"):
        T.check_cache_invariant(old, {"k": torch.zeros(2, 4),
                                      "v": torch.zeros(2, 3)})
    with pytest.raises(RuntimeError, match="contract"):
        T.check_cache_invariant(old, {"k": torch.zeros(2, 3).double(),
                                      "v": torch.zeros(2, 3)})
    with pytest.raises(RuntimeError, match="structure"):
        T.check_cache_invariant(old, {"k": torch.zeros(2, 3)})
