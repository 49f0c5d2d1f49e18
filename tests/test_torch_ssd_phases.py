"""The SSD scan's chunk-parallel decomposition, on the CPU, against the
JAX package's SSD kernel.

On the card the scan runs in three phases: each chunk's own contribution
to the state (chunk states), the recurrence over chunks (state pass), and
each chunk's output from the state entering it (chunk output).  Here the
plain versions of the three phases (``kernels/ssd_chunk/ref.py``),
composed, are held in f32 to ``repro.kernels.ssd_scan`` run in interpret
mode (as ``tests/test_kernels.py`` runs it), at the reference's SSD
tolerance (1e-4, ``tests/test_kernels.py:220-221``): on the reference
grid, with a short last chunk, across chunk lengths, and with B and C
given as one group broadcast to every head (head stride 0), as
``models/ssm.py`` hands them over.  Two properties of the decomposition
are held on their own: a chunk's state is the final state of a scan of
that chunk alone, and positions with dt = 0 past S add nothing.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ssd_chunk import (ssd_chunk_output_ref,
                                           ssd_chunk_states_ref,
                                           ssd_state_pass_ref)

TOL = dict(rtol=1e-4, atol=1e-4)
GRID = [(1, 128, 2, 64, 32, 32),     # tests/test_kernels.py:205-209
        (2, 256, 4, 32, 64, 64),
        (1, 64, 1, 16, 16, 64)]      # single chunk


@pytest.fixture(scope="module")
def jax_ssd():
    """The reference's SSD kernel in interpret mode, numpy in and out
    (imported here, so that collection does not need JAX)."""
    import jax.numpy as jnp

    from repro.kernels import ssd_scan as ref_scan

    def run(x, dt, a, bmat, cmat, chunk):
        y, hf = ref_scan(*(jnp.asarray(np.asarray(v))
                           for v in (x, dt, a, bmat, cmat)),
                         chunk=chunk, interpret=True)
        return np.asarray(y), np.asarray(hf)
    return run


def _inputs(b, s, h, p, n, seed):
    """tests/test_kernels.py:211-216 with numpy draws."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1
    a = -np.exp(rng.standard_normal(h) * 0.3)
    bmat = rng.standard_normal((b, s, h, n), np.float32) * 0.5
    cmat = rng.standard_normal((b, s, h, n), np.float32) * 0.5
    return (x, dt.astype(np.float32), a.astype(np.float32), bmat, cmat)


def _phases(args, chunk):
    """The three plain phases composed: (y, h_final)."""
    args = [torch.as_tensor(v) for v in args]
    states, decay = ssd_chunk_states_ref(*args, chunk=chunk)
    h_prev, hf = ssd_state_pass_ref(states, decay)
    return ssd_chunk_output_ref(*args, h_prev, chunk=chunk), hf


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", GRID)
def test_phases_match_pallas_on_the_grid(b, s, h, p, n, chunk, jax_ssd):
    args = _inputs(b, s, h, p, n, seed=4)
    y, hf = _phases(args, chunk)
    assert tuple(y.shape) == (b, s, h, p) and tuple(hf.shape) == (b, h, p, n)
    y_j, hf_j = jax_ssd(*args, chunk)
    _close(y, y_j)
    _close(hf, hf_j)


@pytest.mark.parametrize("s,chunk", [(100, 32), (300, 256), (7, 4),
                                     (65, 64), (257, 256)])
def test_phases_short_last_chunk(s, chunk, jax_ssd):
    """S not a multiple of the chunk: the last chunk is shorter, and the
    scan equals the reference over one chunk of all S positions."""
    args = _inputs(2, s, 3, 16, 32, seed=6)
    y, hf = _phases(args, chunk)
    y_j, hf_j = jax_ssd(*args, s)
    _close(y, y_j)
    _close(hf, hf_j)


@pytest.mark.parametrize("chunk", [1, 3, 16, 32, 128])
def test_phases_chunk_invariance(chunk, jax_ssd):
    """The decomposition does not depend on the chunk length
    (tests/test_kernels.py:224-243)."""
    args = _inputs(1, 128, 2, 32, 32, seed=5)
    y, hf = _phases(args, chunk)
    y_j, hf_j = jax_ssd(*args, 16)
    _close(y, y_j)
    _close(hf, hf_j)


@pytest.mark.parametrize("chunk", [32, 100])
def test_phases_read_a_group_broadcast(chunk, jax_ssd):
    """B and C as one group expanded to every head (head stride 0, the
    model's ngroups = 1 view) give the reference's scan of per-head
    copies; so does the wrapper's CPU path."""
    x, dt, a, bmat, cmat = _inputs(2, 200, 4, 16, 32, seed=8)
    b_g = torch.tensor(bmat[:, :, :1]).expand(2, 200, 4, 32)
    c_g = torch.tensor(cmat[:, :, :1]).expand(2, 200, 4, 32)
    assert b_g.stride(2) == 0
    y, hf = _phases((x, dt, a, b_g, c_g), chunk)
    y_j, hf_j = jax_ssd(x, dt, a, b_g.contiguous(), c_g.contiguous(), 200)
    _close(y, y_j)
    _close(hf, hf_j)
    args = (torch.tensor(x), torch.tensor(dt), torch.tensor(a))
    y_w, hf_w = ssd_scan(*args, b_g, c_g, chunk=100)
    y_c, hf_c = ssd_scan(*args, b_g.contiguous(), c_g.contiguous(),
                         chunk=100)
    assert torch.equal(y_w, y_c) and torch.equal(hf_w, hf_c)
    _close(y_w, y_j)


@pytest.mark.parametrize("chunk", [16, 48])
def test_chunk_state_is_the_chunks_own_final_state(chunk, jax_ssd):
    """S_c, each chunk's own contribution to the state, is the final state
    of the reference's scan of that chunk alone from a zero state."""
    args = _inputs(1, 100, 2, 16, 32, seed=9)
    states, decay = ssd_chunk_states_ref(*(torch.tensor(v) for v in args),
                                         chunk=chunk)
    for c in range(states.shape[2]):
        sl = slice(c * chunk, min(100, (c + 1) * chunk))
        x, dt, a, bmat, cmat = args
        _, hf_j = jax_ssd(x[:, sl], dt[:, sl], a, bmat[:, sl], cmat[:, sl],
                          sl.stop - sl.start)
        _close(states[:, :, c], hf_j)
        cum_last = (torch.tensor(dt[:, sl]) * torch.tensor(a)).sum(1)
        torch.testing.assert_close(decay[:, :, c], cum_last, rtol=1e-5,
                                   atol=1e-5)


def test_an_empty_tail_adds_nothing():
    """Positions with dt = 0 appended past S change neither y over the
    first S positions nor the final state: the phases pad a short last
    chunk the same way."""
    x, dt, a, bmat, cmat = _inputs(2, 100, 3, 16, 32, seed=10)
    rng = np.random.default_rng(11)

    def tail(v):
        return np.concatenate([v, rng.standard_normal(
            (v.shape[0], 28) + v.shape[2:]).astype(np.float32)], 1)
    dt_t = np.concatenate([dt, np.zeros((2, 28, 3), np.float32)], 1)
    y, hf = _phases((x, dt, a, bmat, cmat), 32)
    y_t, hf_t = _phases((tail(x), dt_t, a, tail(bmat), tail(cmat)), 32)
    torch.testing.assert_close(y_t[:, :100], y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(hf_t, hf, rtol=1e-6, atol=1e-6)
