"""The SSD scan's backward on the CPU: its plain decomposition against
autograd, and the port's gradients against the JAX package's.

On the card the scan's gradient is ``SSDScanFn``'s backward, the kernel of
``csrc/ssd_chunk_bwd.cu``, whose plain version phase by phase is in
``kernels/ssd_chunk/ref.py``: the forward's chunk states and state pass
again, each chunk's pull on the state entering it, the reverse state pass
(the gradient of the state leaving each chunk), C B^T once per (batch,
chunk, group) (``ssd_cb_ref``: G = 1 where B and C are one group's view of
head stride 0, as ``models/ssm.py`` hands them to the scan for mamba2 and
jamba, else one per head) and the within-chunk gradients.  Here, in f32
at small sizes:

* that decomposition equals autograd through ``ssd_scan_ref`` (dx, ddt,
  da and the per-head dB, dC), with a short last chunk, several groups
  and a nonzero gradient of h_final, by both C B^T routes: one group
  broadcast to its heads by a stride-0 view (G = 1), and B and C copied
  to each head (G = H);
* the plain C B^T phase gives every head of a stride-0 view the one
  group's lower triangle, the same numbers as the per-head route, zero
  above the diagonal and past S;
* the port's gradients, and the plain decomposition by both routes,
  equal ``jax.vjp`` of the reference's ``repro.models.ssm.ssd_chunked``
  on the same numpy inputs, at S a multiple of the chunk (the reference
  asserts equal chunks);
* four planted faults of the backward fail the checks: the gradient of
  the carried state dropped (the reverse pass does not propagate), one
  chunk's dB zeroed, dB multiplied by the group's head count (what a
  group sum handed back through a stride-0 view would do), and one tile
  pair of the C B^T scratch zeroed (dx's rows of that chunk);
* ``ssd_scan`` on the CPU under autograd takes the plain path: no
  ``SSDScanFn``, no launch counted.

Tolerance: rtol 1e-5 / atol 1e-5 of the gradient's largest value between
the plain decomposition and autograd (both f32 in PyTorch, sums in other
orders), and 1e-4 of it against JAX (XLA:CPU's einsums and cumsums in
another order, the reference's SSD tolerance, tests/test_kernels.py:
220-221).  ddt and da come out of a reverse cumsum whose terms cancel,
so every gradient is held against its own largest value.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_scan, ssd_scan_bwd, ssd_scan_bwd_ref
from repro_torch.kernels.ssd_chunk import (SSDScanFn, bwd_groups,
                                           ssd_cb_ref, ssd_chunk_grads_ref,
                                           ssd_chunk_states_ref,
                                           ssd_dstates_ref,
                                           ssd_scan_bwd_phases_ref,
                                           ssd_state_pass_bwd_ref,
                                           ssd_state_pass_ref)

NAMES = ("dx", "ddt", "da", "dB", "dC")
# (B, S, H, P, N, G, chunk): a short last chunk (37 at 8, 100 at 32), one
# chunk, G > 1, and the reference grid's
CASES = [(2, 37, 4, 8, 16, 2, 8), (1, 100, 3, 16, 8, 1, 32),
         (1, 16, 2, 4, 8, 2, 16), (1, 128, 2, 64, 32, 1, 32),
         (2, 64, 6, 8, 8, 3, 16)]


def _inputs(b, s, h, p, n, g, seed=0):
    """numpy draws as tests/test_kernels.py:211-216, B and C per group."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1
          ).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bg = rng.standard_normal((b, s, g, n), np.float32) * 0.5
    cg = rng.standard_normal((b, s, g, n), np.float32) * 0.5
    dy = rng.standard_normal((b, s, h, p), np.float32)
    dhf = rng.standard_normal((b, h, p, n), np.float32)
    return x, dt, a, bg, cg, dy, dhf


def _heads(t, h):
    """(B, S, G, N) -> (B, S, H, N), each group to its h // G heads, as
    ``models/ssm.py`` broadcasts them."""
    b, s, g, n = t.shape
    return t[:, :, :, None].expand(b, s, g, h // g, n).reshape(b, s, h, n)


def _per_head(t, h):
    """(B, S, G, N) -> each head's own copy (B, S, H, N), head stride N:
    the per-head route (for G = 1 ``_heads`` is a stride-0 view)."""
    return _heads(t, h).contiguous()


def _group_view(t, h):
    """(B, S, 1, N) -> its stride-0 view over H heads, as
    ``models/ssm.py`` hands one group's B and C to the scan."""
    b, s, g, n = t.shape
    assert g == 1
    return t.expand(b, s, h, n)


def _close(got, want, rel, what):
    got, want = (np.asarray(t, np.float64) for t in (got, want))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=what)


def _torch(arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_dhf", [False, True])
def test_plain_phases_match_autograd(case, with_dhf):
    b, s, h, p, n, g, chunk = case
    x, dt, a, bg, cg, dy, dhf = _torch(_inputs(b, s, h, p, n, g, seed=1))
    bm, cm = _heads(bg, h), _heads(cg, h)
    dhf = dhf if with_dhf else None
    want = ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, dhf, chunk=chunk)
    got = ssd_scan_bwd_phases_ref(x, dt, a, bm, cm, dy, dhf, chunk=chunk)
    for name, gt, wt in zip(NAMES, got, want):
        assert gt.shape == wt.shape and gt.dtype == wt.dtype, name
        _close(gt, wt, 1e-5, f"{name} {case}")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_dhf", [False, True])
def test_plain_phases_match_autograd_per_head(case, with_dhf):
    """The per-head route (G = H) at every group count: B and C each
    head's own copy.  (``test_plain_phases_match_autograd`` takes G = 1
    where the model would, one group broadcast by a stride-0 view.)"""
    b, s, h, p, n, g, chunk = case
    x, dt, a, bg, cg, dy, dhf = _torch(_inputs(b, s, h, p, n, g, seed=1))
    bm, cm = _per_head(bg, h), _per_head(cg, h)
    assert bwd_groups(bm, cm) == h
    assert bwd_groups(_heads(bg, h), _heads(cg, h)) == (1 if g == 1 else h)
    dhf = dhf if with_dhf else None
    want = ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, dhf, chunk=chunk)
    got = ssd_scan_bwd_phases_ref(x, dt, a, bm, cm, dy, dhf, chunk=chunk)
    for name, gt, wt in zip(NAMES, got, want):
        assert gt.shape == wt.shape and gt.dtype == wt.dtype, name
        _close(gt, wt, 1e-5, f"{name} {case}")


@pytest.mark.parametrize("case", [(2, 37, 4, 8, 16, 1, 8),
                                  (1, 100, 3, 16, 8, 1, 32),
                                  (1, 200, 2, 8, 16, 1, 128)])
def test_cb_once_per_group_equals_per_head(case):
    """The plain C B^T phase: (B, nc, G, T, T) with T the chunk rounded up
    to 64; one group's stride-0 view gives G = 1 and the same lower
    triangle as each head's own copy (G = H); zero above the diagonal and
    at positions past S (a short last chunk)."""
    b, s, h, p, n, g, chunk = case
    _, _, _, bg, cg, _, _ = _torch(_inputs(b, s, h, p, n, g, seed=8))
    one = ssd_cb_ref(_group_view(bg, h), _group_view(cg, h), chunk=chunk)
    per_head = ssd_cb_ref(_per_head(bg, h), _per_head(cg, h), chunk=chunk)
    nc, t = -(-s // chunk), -(-chunk // 64) * 64
    assert one.shape == (b, nc, 1, t, t)
    assert per_head.shape == (b, nc, h, t, t)
    for k in range(h):
        torch.testing.assert_close(per_head[:, :, k], one[:, :, 0],
                                   rtol=0, atol=0)
    assert not one.triu(1).any()
    assert not one[..., chunk:, :].any() and not one[..., chunk:].any()
    last = s - (nc - 1) * chunk             # live positions of the last chunk
    assert not one[:, -1, :, last:].any() and not one[:, -1, :, :, last:].any()
    want = torch.einsum("bin,bjn->bij", cg[:, :chunk, 0], bg[:, :chunk, 0])
    torch.testing.assert_close(one[:, 0, 0, :chunk, :chunk], want.tril())


@pytest.mark.parametrize("case", CASES)
def test_group_sums_match_autograd_through_the_model_layout(case):
    """dB and dC per head, summed over each group's heads, are the
    gradients of the group tensors the model broadcasts."""
    b, s, h, p, n, g, chunk = case
    x, dt, a, bg, cg, dy, dhf = _torch(_inputs(b, s, h, p, n, g, seed=2))
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, bg, cg)]
    y, hf = ssd_scan(leaves[0], leaves[1], leaves[2], _heads(leaves[3], h),
                     _heads(leaves[4], h), chunk=chunk)
    want = torch.autograd.grad((y, hf), leaves, (dy, dhf))
    got = ssd_scan_bwd_phases_ref(x, dt, a, _heads(bg, h), _heads(cg, h),
                                  dy, dhf, chunk=chunk)
    rep = h // g
    got = list(got[:3]) + [t.unflatten(2, (g, rep)).sum(3) for t in got[3:]]
    for name, gt, wt in zip(NAMES, got, want):
        _close(gt, wt, 1e-5, f"{name} {case}")


def test_reverse_pass_seeds_from_dh_final():
    """With dy = 0 the only gradient is dh_final's, carried back through
    the chunks' decays: D_c = exp(sum of the later chunks' cum_last)
    dh_final."""
    x, dt, a, bg, cg, _, dhf = _torch(_inputs(1, 48, 2, 4, 8, 1, seed=3))
    bm, cm = _heads(bg, 2), _heads(cg, 2)
    _, decay = ssd_chunk_states_ref(x, dt, a, bm, cm, chunk=16)
    dstates = ssd_dstates_ref(torch.zeros_like(x), dt, a, cm, chunk=16)
    assert not dstates.any()
    d, d0 = ssd_state_pass_bwd_ref(dstates, decay, dhf)
    for c in range(3):
        k = torch.exp(decay[:, :, c + 1:].sum(-1))[..., None, None]
        torch.testing.assert_close(d[:, :, c], k * dhf)
    torch.testing.assert_close(
        d0, torch.exp(decay.sum(-1))[..., None, None] * dhf)


@pytest.mark.parametrize("case", [(1, 64, 2, 8, 16, 1, 16),
                                  (2, 64, 4, 16, 8, 2, 32)])
def test_port_gradients_match_jax_vjp(case):
    import jax
    import jax.numpy as jnp

    from repro.models.ssm import ssd_chunked

    b, s, h, p, n, g, chunk = case
    arrays = _inputs(b, s, h, p, n, g, seed=4)
    x, dt, a, bg, cg, dy, dhf = arrays

    def jfn(x_, dt_, a_, bg_, cg_):
        rep = h // g

        def heads(t):
            return jnp.repeat(t, rep, axis=2)
        return ssd_chunked(x_, dt_, a_, heads(bg_), heads(cg_), chunk,
                           jnp.zeros((b, h, p, n), jnp.float32))
    _, vjp = jax.vjp(jfn, *(jnp.asarray(t) for t in (x, dt, a, bg, cg)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dhf)))

    xt, dtt, at, bgt, cgt, dyt, dhft = _torch(arrays)
    got = ssd_scan_bwd(xt, dtt, at, _heads(bgt, h), _heads(cgt, h), dyt,
                       dhft, chunk=chunk)
    got = list(got[:3]) + [t.unflatten(2, (g, h // g)).sum(3)
                           for t in got[3:]]
    for name, gt, wt in zip(NAMES, got, want):
        _close(gt.numpy(), np.asarray(wt), 1e-4, f"{name} vs jax.vjp")


@pytest.mark.parametrize("layout", ["one_group_view", "per_head"])
@pytest.mark.parametrize("case", [(1, 64, 2, 8, 16, 1, 16),
                                  (2, 128, 4, 16, 8, 1, 64)])
def test_plain_phases_match_jax_vjp(case, layout):
    """The plain decomposition by both C B^T routes against ``jax.vjp``
    of the reference's ``ssd_chunked``."""
    import jax
    import jax.numpy as jnp

    from repro.models.ssm import ssd_chunked

    b, s, h, p, n, g, chunk = case
    arrays = _inputs(b, s, h, p, n, g, seed=9)
    x, dt, a, bg, cg, dy, dhf = arrays

    def jfn(x_, dt_, a_, bm_, cm_):
        return ssd_chunked(x_, dt_, a_, bm_, cm_, chunk,
                           jnp.zeros((b, h, p, n), jnp.float32))
    heads = np.repeat
    _, vjp = jax.vjp(jfn, *(jnp.asarray(t) for t in (
        x, dt, a, heads(bg, h, axis=2), heads(cg, h, axis=2))))
    want = vjp((jnp.asarray(dy), jnp.asarray(dhf)))

    xt, dtt, at, bgt, cgt, dyt, dhft = _torch(arrays)
    spread = _group_view if layout == "one_group_view" else _per_head
    bm, cm = spread(bgt, h), spread(cgt, h)
    assert bwd_groups(bm, cm) == (1 if layout == "one_group_view" else h)
    got = ssd_scan_bwd_phases_ref(xt, dtt, at, bm, cm, dyt, dhft,
                                  chunk=chunk)
    for name, gt, wt in zip(NAMES, got, want):
        _close(gt.numpy(), np.asarray(wt), 1e-4, f"{name} vs jax.vjp")


def _faulty(x, dt, a, bm, cm, dy, dhf, chunk, fault):
    """The plain decomposition with one fault planted."""
    states, decay = ssd_chunk_states_ref(x, dt, a, bm, cm, chunk=chunk)
    h_prev, h_final = ssd_state_pass_ref(states, decay)
    dstate, _ = ssd_state_pass_bwd_ref(
        ssd_dstates_ref(dy, dt, a, cm, chunk=chunk), decay, dhf)
    if fault == "carry_dropped":        # the reverse pass does not propagate
        dstate[:, :, :-1] = 0
    cb = ssd_cb_ref(bm, cm, chunk=chunk)
    if fault == "cb_tile_zeroed":       # the second chunk's diagonal tile
        cb[:, 1, :, :64, :64] = 0
    grads = list(ssd_chunk_grads_ref(x, dt, a, bm, cm, dy, h_prev, h_final,
                                     dstate, cb, chunk=chunk))
    if fault == "chunk_db_zeroed":      # the second chunk's dB
        grads[3][:, chunk:2 * chunk] = 0
    return grads


@pytest.mark.parametrize("fault", ["carry_dropped", "chunk_db_zeroed",
                                   "db_times_heads", "cb_tile_zeroed"])
def test_planted_faults_fail(fault):
    """Each fault fails the gradient it corrupts: dB, or for the zeroed
    C B^T tile (which dB does not read) dx."""
    b, s, h, p, n, g, chunk = 1, 64, 4, 8, 16, 1, 16
    x, dt, a, bg, cg, dy, dhf = _torch(_inputs(b, s, h, p, n, g, seed=5))
    leaves = [t.clone().requires_grad_() for t in (x, bg)]
    y, hf = ssd_scan(leaves[0], dt, a, _heads(leaves[1], h), _heads(cg, h),
                     chunk=chunk)
    want_dx, want_db = torch.autograd.grad((y, hf), leaves, (dy, dhf))

    def picked(grads):
        if fault == "cb_tile_zeroed":
            return grads[0], want_dx
        return grads[3].unflatten(2, (g, h)).sum(3), want_db
    got, want = picked(_faulty(x, dt, a, _heads(bg, h), _heads(cg, h), dy,
                               dhf, chunk, fault))
    if fault == "db_times_heads":       # the group sum summed again
        got = got * h
    with pytest.raises(AssertionError):
        _close(got, want, 1e-5, fault)
    # the same decomposition without the fault passes
    got, want = picked(_faulty(x, dt, a, _heads(bg, h), _heads(cg, h), dy,
                               dhf, chunk, None))
    _close(got, want, 1e-5, "clean")


def test_cpu_scan_under_autograd_takes_the_plain_path():
    x, dt, a, bg, cg, dy, _ = _torch(_inputs(1, 40, 2, 4, 8, 1, seed=6))
    x.requires_grad_()
    f0, b0 = ssd_scan.launches.value, ssd_scan_bwd.launches.value
    y, _ = ssd_scan(x, dt, a, _heads(bg, 2), _heads(cg, 2), chunk=16)
    assert y.grad_fn is not None
    assert not isinstance(y.grad_fn, SSDScanFn._backward_cls)
    y.backward(dy)
    assert ssd_scan.launches.value == f0
    assert ssd_scan_bwd.launches.value == b0
    want = ssd_scan_bwd_ref(x.detach(), dt, a, _heads(bg, 2), _heads(cg, 2),
                            dy, chunk=16)[0]
    _close(x.grad, want, 1e-6, "dx")


def test_plain_gradient_is_finite_at_large_step_sizes():
    """At real step sizes cum_i - cum_j overflows f32's exp above the
    diagonal (here up to 128); the plain scan masks before the exp, so
    autograd through it stays finite (before, 0 * inf = nan in every
    head that overflowed) and within 1e-4 of the same gradient taken
    from f64 inputs."""
    arrays = _torch(_inputs(1, 128, 2, 8, 16, 1, seed=7))
    x, _, _, bg, cg, dy, dhf = arrays
    dt = torch.full((1, 128, 2), 0.5)
    a = torch.tensor([-4.0, -2.0])
    args = (x, dt, a, _heads(bg, 2), _heads(cg, 2), dy, dhf)
    got = ssd_scan_bwd_ref(*args, chunk=64)
    want = ssd_scan_bwd_ref(*(t.double() for t in args), chunk=64)
    for name, gt, wt in zip(NAMES, got, want):
        assert torch.isfinite(gt).all(), name
        _close(gt, wt, 1e-4, name)
