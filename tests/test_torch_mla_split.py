"""The MLA decode's split over positions and its combine, on the CPU,
against the JAX package's paged MLA kernel.

On the card the bf16 MLA decode splits each slot's positions over blocks
of ``split_len`` positions (``ops.split_plan``, from shapes only) and
merges their partials with the combine kernel the GQA decode uses.  Here
the plain partials (``paged_mla_decode_partials_ref``: acc, m, l in log2
units) merged by the plain combine (``paged_decode_combine_ref``) are held
in f32 to ``repro.kernels.paged_mla_decode_attention`` run in interpret
mode, at the reference's f32 tolerance (2e-5, ``tests/test_kernels.py:
15-17``): split at arbitrary edges with empty splits, on the plan's own
edges, with every slot at position 0, with the garbage page poisoned,
with pages allocated past ``pos``, and on a plan at the grid's limit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import (
    ops, paged_decode_combine_ref, paged_mla_decode_attention_ref,
    paged_mla_decode_partials_ref, split_plan)

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def jax_mla():
    """The reference's paged MLA kernel in interpret mode, numpy in and
    out (imported here, so that collection does not need JAX)."""
    import jax.numpy as jnp

    from repro.kernels import paged_mla_decode_attention

    def run(args, page_size, scale):
        out = paged_mla_decode_attention(
            *(jnp.asarray(np.asarray(v)) for v in args),
            page_size=page_size, scale=scale, interpret=True)
        return np.asarray(out)
    return run


def _inputs(b, h, rkv, dr, cap, ps, pos, seed, garbage_rest=True):
    """Shuffled pages for each slot's positions; the rest of the table on
    garbage page 0 (or allocated past pos)."""
    rng = np.random.default_rng(seed)
    pps = cap // ps
    phys = rng.permutation(np.arange(1, 1 + b * pps)).astype(np.int32)
    table = np.zeros((b, pps), np.int32)
    for i in range(b):
        n = pps if not garbage_rest else -(-(int(pos[i]) + 1) // ps)
        table[i, :n] = phys[i * pps:i * pps + n]
    f = np.float32
    return [torch.tensor(rng.standard_normal((b, 1, h, rkv), f)),
            torch.tensor(rng.standard_normal((b, 1, h, dr), f)),
            torch.tensor(rng.standard_normal((1 + b * pps, ps, rkv), f)),
            torch.tensor(rng.standard_normal((1 + b * pps, ps, dr), f)),
            torch.tensor(table), torch.tensor(np.asarray(pos, np.int32))]


def _merged(args, ps, scale, edges):
    acc, m, l = paged_mla_decode_partials_ref(*args, page_size=ps,
                                              scale=scale, edges=edges)
    assert torch.equal(l == 0, m == -torch.inf)      # empty = (-inf, 0)
    return paged_decode_combine_ref(acc, m, l, torch.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


EDGES = {"one": [0, 96],
         "even": [0, 32, 64, 96],
         "ragged": [0, 1, 17, 18, 40, 95, 96],
         "empty": [0, 0, 10, 10, 10, 60, 96, 96]}


@pytest.mark.parametrize("edges", list(EDGES))
def test_split_combine_matches_pallas(edges, jax_mla):
    """Any split of the positions, empty splits included, merges to the
    reference's unsplit decode."""
    args = _inputs(4, 6, 32, 16, 96, 4, [0, 17, 63, 95], seed=3)
    got = _merged(args, 4, 0.2, EDGES[edges])
    assert got.shape == (4, 1, 6, 32)
    _close(got, jax_mla(args, 4, 0.2))


@pytest.mark.parametrize("cap,ps", [(2080, 8), (40, 8), (300, 1)])
def test_split_combine_on_the_plan(cap, ps, jax_mla):
    """The kernel's own split edges (from the plan), slots at 0, on the
    edges and at the last position, at a minicpm3-like scale."""
    n, length = split_plan(cap, ps)
    pos = [0, min(length, cap - 1), min(length - 1, cap - 1), cap - 1]
    args = _inputs(4, 8, 32, 16, cap, ps, pos, seed=4)
    edges = [min(z * length, cap) for z in range(n + 1)]
    scale = (64 + 32) ** -0.5
    _close(_merged(args, ps, scale, edges), jax_mla(args, ps, scale))


def test_every_slot_at_position_zero(jax_mla):
    """pos 0 everywhere: only the first split holds a position, every
    other partial is empty, and the output is each slot's first latent
    row."""
    n, length = split_plan(64, 4)
    args = _inputs(3, 4, 16, 8, 64, 4, [0, 0, 0], seed=5)
    edges = [min(z * length, 64) for z in range(n + 1)]
    acc, m, l = paged_mla_decode_partials_ref(*args, page_size=4, scale=0.3,
                                              edges=edges)
    assert bool((l[0] > 0).all()) and bool((l[1:] == 0).all())
    got = paged_decode_combine_ref(acc, m, l, torch.float32)
    first = args[2][args[4][:, 0].long(), 0]                # (B, Rkv)
    torch.testing.assert_close(got[:, 0], first[:, None].expand(3, 4, 16),
                               rtol=1e-6, atol=1e-6)
    _close(got, jax_mla(args, 4, 0.3))


def test_poisoned_garbage_page_is_inert(jax_mla):
    """Page 0 set to 1e4: nothing behind a masked position is read, so
    the partials and the merge are bit-identical and finite."""
    args = _inputs(3, 4, 32, 16, 64, 4, [0, 5, 40], seed=6)
    edges = [0, 16, 32, 48, 64]
    clean = paged_mla_decode_partials_ref(*args, page_size=4, scale=0.2,
                                          edges=edges)
    args[2][0], args[3][0] = 1e4, 1e4
    poisoned = paged_mla_decode_partials_ref(*args, page_size=4, scale=0.2,
                                             edges=edges)
    for c, p in zip(clean, poisoned):
        assert torch.equal(c, p)
    got = paged_decode_combine_ref(*poisoned, torch.float32)
    assert torch.isfinite(got).all()
    _close(got, jax_mla(args, 4, 0.2))


def test_pages_allocated_past_pos_are_masked(jax_mla):
    args = _inputs(2, 2, 16, 8, 32, 4, [2, 9], seed=7, garbage_rest=False)
    _close(_merged(args, 4, 0.2, [0, 8, 16, 24, 32]),
           jax_mla(args, 4, 0.2))


@pytest.mark.parametrize("max_z", [1, 2, 3])
def test_split_plan_at_the_grid_limit(max_z, monkeypatch, jax_mla):
    """With the grid's split limit reached, the plan takes fewer, longer
    splits (whole pages) that still cover the table, and they merge to
    the reference's decode."""
    cap, ps = 1040, 8
    unbound = split_plan(cap, ps)[0]
    monkeypatch.setattr(ops, "MAX_GRID_Z", max_z)
    n, length = split_plan(cap, ps)
    assert n <= max_z < unbound
    assert length % ps == 0 and n * length >= cap > (n - 1) * length
    args = _inputs(3, 5, 16, 8, cap, ps, [0, 600, 1039], seed=8)
    edges = [min(z * length, cap) for z in range(n + 1)]
    got = _merged(args, ps, 0.25, edges)
    _close(got, jax_mla(args, ps, 0.25))
    _close(got, paged_mla_decode_attention_ref(*args, page_size=ps,
                                               scale=0.25))
