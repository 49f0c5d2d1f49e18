"""Port MoE (``repro_torch.models.moe``) vs the reference
``repro.models.moe`` on tiny f32 inputs made with numpy: the router's
top-k picks are equal exactly, the capacity dispatch and the dropless
(ragged) dispatch give the reference's outputs — including a capacity
that really drops picks, in the reference's drop order (token-major,
pick-minor).

Tolerances: rtol 1e-5 / atol 1e-6 — f32 on both sides, the two
frameworks' CPU GEMMs sum in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get
from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

TOL = dict(rtol=1e-5, atol=1e-6)
B, S = 2, 16


def _cfg(**kw):
    return get("mixtral-8x7b").tiny(**kw)


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    xn = rng.standard_normal((B, S, d), np.float32)
    p = {"ln": np.ones(d, np.float32),
         "router": rng.standard_normal((d, e), np.float32) * 0.3,
         "w_gate": rng.standard_normal((e, d, f), np.float32) * 0.1,
         "w_up": rng.standard_normal((e, d, f), np.float32) * 0.1,
         "w_down": rng.standard_normal((e, f, d), np.float32) * 0.1}
    return xn, p


def _both(fn_j, fn_t, cfg, seed):
    xn, p = _inputs(cfg, seed)
    yj, lbj = fn_j(jnp.asarray(xn), {k: jnp.asarray(v) for k, v in p.items()},
                   cfg)
    yt, lbt = fn_t(torch.tensor(xn), {k: torch.tensor(v)
                                      for k, v in p.items()}, cfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(lbt), float(lbj), rtol=1e-5)
    return xn, p


def test_param_shapes_and_capacity_match_reference():
    cfg = _cfg()
    ref = {k: v[0] for k, v in jmoe.moe_param_shapes(cfg).items()}
    assert {k: v[0] for k, v in tmoe.moe_param_shapes(cfg).items()} == ref
    for s in (1, 7, 16, 8192):
        for c in (_cfg(), _cfg(capacity_factor=0.5),
                  get("mixtral-8x7b")):
            assert tmoe.capacity(s, c) == jmoe.capacity(s, c)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_matches_reference(seed):
    cfg = _cfg()
    xn, p = _inputs(cfg, seed)
    vj, ij, lbj = jmoe.route(jnp.asarray(xn), jnp.asarray(p["router"]), cfg)
    vt, it, lbt = tmoe.route(torch.tensor(xn), torch.tensor(p["router"]),
                             cfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)
    np.testing.assert_allclose(float(lbt), float(lbj), rtol=1e-5)
    assert tmoe.route(torch.tensor(xn), torch.tensor(p["router"]), cfg,
                      aux=False)[2] is None


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_mlp_matches_reference(seed):
    _both(jmoe.moe_mlp, tmoe.moe_mlp, _cfg(), seed)


@pytest.mark.parametrize("capacity_factor", [0.5, 0.25])
def test_moe_mlp_drops_like_the_reference(capacity_factor):
    """A capacity below the load really drops picks, and the port drops
    the same ones as the reference."""
    cfg = _cfg(capacity_factor=capacity_factor)
    xn, p = _both(jmoe.moe_mlp, tmoe.moe_mlp, cfg, seed=3)
    _, topi, _ = tmoe.route(torch.tensor(xn), torch.tensor(p["router"]),
                            cfg)
    _, _, keep = tmoe.dispatch_slots(topi, cfg, tmoe.capacity(S, cfg))
    assert not keep.all(), "no pick was dropped: the case tests nothing"


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_mlp_ragged_matches_reference(seed):
    _both(jmoe.moe_mlp_ragged, tmoe.moe_mlp_ragged, _cfg(moe_impl="ragged"),
          seed)


def test_capacity_dispatch_without_drops_equals_dropless():
    """With room for every pick the two dispatches compute the same
    function."""
    cfg = _cfg(capacity_factor=4.0)
    xn, p = _inputs(cfg, 4)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    y1, _ = tmoe.moe_mlp(torch.tensor(xn), tp, cfg)
    y2, _ = tmoe.moe_mlp_ragged(torch.tensor(xn), tp, cfg)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), **TOL)
