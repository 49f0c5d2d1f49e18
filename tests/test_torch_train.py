"""The port's train step (``repro_torch.steps.make_train_step``) against
the reference's (``jax.jit(repro.steps.make_train_step(cfg, None, hp))``)
on the tiny f32 configs of the five text families: qwen2.5-14b (GQA),
minicpm3-4b (MLA), mamba2-780m (SSD), mixtral-8x7b (GQA + MoE, so the
load-balance term is in the loss) and jamba-v0.1-52b (SSD + attention +
MoE).  One step from the same state — the reference's
``init_train_state`` handed over as numpy (``train_state_from_numpy``)
— on the same ``batch_for_step(..., accum=2)``.

Tolerances (the two frameworks sum in different orders: XLA:CPU's and
PyTorch's GEMMs and reductions, through every layer and back):
  * loss rtol 1e-5; grad_norm rtol 1e-4; lr rtol 1e-6;
  * every param leaf after the step within atol 1e-6 (rtol 1e-5), except
    where the reference's clipped gradient (10 |m| after one step) is
    below ``SENSITIVE`` = 1e-7, ten times AdamW's eps: there the step
    ``lr * g / (|g| + eps)`` turns on the gradient's last bits, and such
    an element is held only within 2 lr, the widest one step can differ
    (a handful of elements in mixtral, minicpm3 and jamba, none in qwen
    and mamba2);
  * m and v (f32 in three families) by their relative L2 error per
    leaf, 1e-4: they are 0.1 g and 0.05 g^2 after one step, so they carry
    the gradients' own error; mixtral's and jamba's m and v are stored in
    bf16 (``opt_dtype``): there the bound is 1e-2, the bf16 rounding
    (2^-9 relative) of values that may round the other way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.configs import get
from repro.data import batch_for_step
from repro.optim import OptHParams as JHP
from repro_torch import steps as tsteps
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import OptHParams
from repro_torch.params import train_state_from_numpy

# jamba-v0.1-52b, the slowest to compile, runs the same check from
# tests/test_torch_train_loop.py, which spreads the files' times
ARCHS = ["qwen2.5-14b", "minicpm3-4b", "mamba2-780m", "mixtral-8x7b"]
HP = dict(lr=1e-3, warmup=3, total_steps=100)
SENSITIVE = 1e-7


def _np(x):
    """A leaf as f32 numpy (bf16 leaves of either side included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want):
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (den if den else 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    check_step_against_reference(arch)


def check_step_against_reference(arch, batch=None):
    """``batch``: the step's batch (default ``batch_for_step(0, ...)`` of
    4 x 16 tokens in 2 microbatches)."""
    cfg = get(arch).tiny()
    jstate = jsteps.init_train_state(cfg, jax.random.PRNGKey(0), JHP(**HP))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                    "cpu")
    assert tstate["params"]["final_norm"].dtype == torch.float32
    if batch is None:
        batch = batch_for_step(0, seed=11, batch=4, seq=16, vocab=cfg.vocab,
                               accum=2)
    jnew, jm = jax.jit(jsteps.make_train_step(cfg, None, JHP(**HP)))(
        jstate, batch)
    tnew, tm = tsteps.make_train_step(cfg, OptHParams(**HP))(tstate, batch)

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    assert tnew["step"].dtype == torch.int32 and tnew["step"].dim() == 0

    jp = jax.tree.leaves(jnew["params"])
    tp = tree_leaves(tnew["params"])
    jg = jax.tree.leaves(jnew["opt"]["m"])         # 0.1 * clipped grad
    assert len(jp) == len(tp) == len(jg)
    lr = float(jm["lr"])
    for i, (t, j, g) in enumerate(zip(tp, jp, jg)):
        assert t.dtype == torch.float32
        got, want = _np(t), _np(j)
        g = 10 * np.abs(_np(g))
        calm = (g >= SENSITIVE) | (g == 0)     # 0: a row no token reads
        np.testing.assert_allclose(got[calm], want[calm], rtol=1e-5,
                                   atol=1e-6,
                                   err_msg=f"{arch} param leaf {i}")
        assert np.abs(got - want).max() <= 2 * lr, (arch, i)
    bound = 1e-2 if cfg.opt_dtype == "bfloat16" else 1e-4
    for k in ("m", "v"):
        for i, (t, j) in enumerate(zip(tree_leaves(tnew["opt"][k]),
                                       jax.tree.leaves(jnew["opt"][k]))):
            assert str(t.dtype) == f"torch.{cfg.opt_dtype}"
            assert _rel(_np(t), _np(j)) <= bound, (arch, k, i)
