"""The port's optimizer (``repro_torch.optim``) against the reference's
(``repro.optim``) on the same numpy inputs, and the reference's own bars
(``tests/test_optim.py``) repeated on the port.

Tolerances: the schedule rtol 1e-6 (f32 arithmetic in both, cos taken by
two libraries); AdamW params rtol 1e-6 / atol 1e-7 over three steps (the
same f32 formula; ``global_norm`` sums the squares in another order, and
an element's update ``m / (sqrt(v) + eps)`` is held away from the
eps-sensitive regime by gradients of size ~1); m and v in f32 rtol 1e-6,
in bf16 one bf16 ulp (rtol 2^-7: both round the same f32 value, which
may differ in its last bits); int8 compression: the quantised values
equal except where ``g / scale`` sits within 1e-5 of a rounding tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch.optim import (OptHParams, adamw_init, adamw_update,
                               compress_grads, decompress_grads, ef_init,
                               global_norm, lr_schedule)


def _tree(rng, scale=1.0):
    return {"w": rng.standard_normal((16, 8)).astype(np.float32) * scale,
            "blocks": ({"a": rng.standard_normal(5).astype(np.float32)
                        * scale},
                       {"a": rng.standard_normal(5).astype(np.float32)
                        * scale}),
            "b": np.zeros(8, np.float32)}


def _t(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)).to(dtype),
                        tree)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


def test_lr_schedule_matches_reference():
    hp = OptHParams(lr=1e-3, warmup=10, total_steps=100, min_lr_frac=0.1)
    jhp = jopt.OptHParams(**hp._asdict())
    for s in list(range(0, 120, 7)) + [9, 10, 11, 99, 100]:
        np.testing.assert_allclose(float(lr_schedule(torch.tensor(s), hp)),
                                   float(jopt.lr_schedule(jnp.asarray(s),
                                                          jhp)), rtol=1e-6)
        assert float(lr_schedule(s, hp)) == float(
            lr_schedule(torch.tensor(s), hp))


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_over_three_steps(opt_dtype):
    rng = np.random.default_rng(0)
    hp = OptHParams(lr=1e-2, warmup=2, total_steps=10, clip_norm=3.0)
    jhp = jopt.OptHParams(**hp._asdict())
    p0 = _tree(rng)
    jp, topt_p = jax.tree.map(jnp.asarray, p0), _t(p0)
    jo = jopt.adamw_init(jp, opt_dtype)
    to = adamw_init(topt_p, opt_dtype)
    for step in range(3):
        g = _tree(rng, 1.0 + step)
        jp, jo, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, g), jo, jp,
                                       jnp.asarray(step, jnp.int32), jhp)
        same, to, tm = adamw_update(_t(g), to, topt_p,
                                    torch.tensor(step, dtype=torch.int32),
                                    hp)
        assert same is topt_p                         # in place
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(topt_p)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6, atol=1e-7)
    tol = dict(rtol=1e-6) if opt_dtype == "float32" else dict(rtol=2 ** -7)
    for k in ("m", "v"):
        for a, b in zip(jax.tree.leaves(jo[k]), jax.tree.leaves(to[k])):
            assert str(b.dtype) == f"torch.{opt_dtype}"
            np.testing.assert_allclose(_np(b), _np(a), atol=1e-12, **tol)


def test_global_norm_matches_reference():
    g = _tree(np.random.default_rng(3), 5.0)
    np.testing.assert_allclose(float(global_norm(_t(g))),
                               float(jopt.adamw.global_norm(g)), rtol=1e-6)


def test_lr_schedule_warmup_and_cosine():
    hp = OptHParams(lr=1e-3, warmup=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(lr_schedule(s, hp)) for s in range(100)]
    assert lrs[0] < lrs[5] < lrs[9]              # warmup ramps
    assert abs(lrs[10] - 1e-3) / 1e-3 < 0.02     # peak at warmup end
    assert lrs[-1] >= 1e-4 * 0.99                # floor respected
    assert all(a >= b - 1e-12 for a, b in zip(lrs[10:], lrs[11:]))


def test_adamw_decays_unused_weights():
    hp = OptHParams(lr=1e-2, warmup=1, weight_decay=0.1, total_steps=10)
    params = {"w": torch.ones((4, 4))}
    opt = adamw_init(params)
    new_p, _, _ = adamw_update({"w": torch.zeros((4, 4))}, opt, params,
                               torch.tensor(5), hp)
    assert float(new_p["w"][0, 0]) < 1.0         # pure decay shrinks


def test_adamw_clips_global_norm():
    hp = OptHParams(lr=1e-3, warmup=1, clip_norm=1.0, total_steps=10)
    p0 = _t(_tree(np.random.default_rng(0)))
    grads = jax.tree.map(lambda p: torch.full(p.shape, 100.0), p0)
    params = jax.tree.map(torch.clone, p0)
    _, _, metrics = adamw_update(grads, adamw_init(params), params,
                                 torch.tensor(5), hp)
    assert float(metrics["grad_norm"]) > 100.0   # raw norm reported
    d1 = max(float((a - b).abs().max()) for a, b in
             zip(jax.tree.leaves(params), jax.tree.leaves(p0)))
    assert d1 < 5e-3                             # lr * O(1) per element


@pytest.mark.parametrize("seed", range(20))
def test_compression_roundtrip_bounded_error(seed):
    g = {"w": torch.tensor(np.random.default_rng(seed).standard_normal(32)
                           .astype(np.float32) * 3.0)}
    q, scales, ef2 = compress_grads(g, ef_init(g))
    deq = decompress_grads(q, scales)
    amax = float(g["w"].abs().max())
    err = float((deq["w"] - g["w"]).abs().max())
    assert q["w"].dtype == torch.int8
    assert err <= amax / 127.0 + 1e-6            # one quantisation step
    np.testing.assert_allclose(ef2["w"].numpy(), (g["w"] - deq["w"]).numpy(),
                               atol=1e-6)


def test_error_feedback_recovers_signal_over_steps():
    g = {"w": torch.cat([torch.full((1,), 10.0), torch.full((7,), 0.01)])}
    ef = ef_init(g)
    total = torch.zeros(8)
    for _ in range(30):
        q, scales, ef = compress_grads(g, ef)
        total = total + decompress_grads(q, scales)["w"]
    assert abs(float(total[1:].mean()) / 30 - 0.01) < 0.005


def test_compression_matches_reference():
    """On a tree of dicts: the reference's ``compress_grads`` takes every
    tuple for a (q, scale) pair (``is_leaf``), so it cannot take the
    model's params, whose ``blocks`` is a tuple; the port's can (next
    test)."""
    g = _tree(np.random.default_rng(5), 2.0)
    g["blocks"] = {str(i): b for i, b in enumerate(g["blocks"])}
    ef = jax.tree.map(lambda a: (a * 0.01).astype(np.float32), g)
    jq, js, jef = jopt.compress_grads(jax.tree.map(jnp.asarray, g),
                                      jax.tree.map(jnp.asarray, ef))
    tq, ts, tef = compress_grads(_t(g), _t(ef))
    for a, b, s, c in zip(jax.tree.leaves(jq), jax.tree.leaves(tq),
                          jax.tree.leaves(js), jax.tree.leaves(ts)):
        np.testing.assert_allclose(float(c), float(s), rtol=1e-6)
        diff = np.asarray(a, np.int32) != b.numpy().astype(np.int32)
        assert diff.sum() <= 1
    for a, b in zip(jax.tree.leaves(jef), jax.tree.leaves(tef)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1.5 * max(
            float(x) for x in jax.tree.leaves(js)))
    for a, b in zip(jax.tree.leaves(jopt.decompress_grads(jq, js)),
                    jax.tree.leaves(decompress_grads(tq, ts))):
        assert b.dtype == torch.float32 and b.shape == np.shape(a)


def test_compression_takes_a_tree_with_tuples():
    g = _t(_tree(np.random.default_rng(6)))
    q, scales, ef = compress_grads(g, ef_init(g))
    assert isinstance(q["blocks"], tuple) and len(q["blocks"]) == 2
    back = decompress_grads(q, scales)
    for a, b, e in zip(jax.tree.leaves(g), jax.tree.leaves(back),
                       jax.tree.leaves(ef)):
        np.testing.assert_allclose((b + e).numpy(), a.numpy(), atol=1e-6)
