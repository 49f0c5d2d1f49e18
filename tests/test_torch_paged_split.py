"""The GQA paged decode's split plan and its combine, on the CPU.

The card's kernel splits each slot's positions over blocks of
``split_len`` positions and merges their partials by log-sum-exp.  Here
the plan (a pure function of shapes) is held to its limits, and the plain
split + combine (``paged_attention/ref.py``) is held to the unsplit plain
version: split at arbitrary boundaries, empty splits included, the merge
equals it within 1e-6 in f32 (the two sum the same terms in another
order).
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import (paged_decode_attention_ref,
                                                 paged_decode_combine_ref,
                                                 paged_decode_partials_ref,
                                                 split_plan)
from repro_torch.kernels.paged_attention.ops import (MAX_GRID_Z,
                                                     SPLIT_POSITIONS)

# tables of 1 page to 2**22 pages: the largest reach the grid's z limit
PLAN_SHAPES = [(pages * ps, ps)
               for pages in (1, 2, 5, 31, 32, 33, 260, 1028, 4096, 2 ** 20,
                             2 ** 22)
               for ps in (1, 4, 8, 16, 64)]


@pytest.mark.parametrize("cap,ps", PLAN_SHAPES)
def test_split_plan_covers_capacity_within_grid(cap, ps):
    n, length = split_plan(cap, ps)
    assert length % ps == 0 and length >= ps
    assert n * length >= cap > (n - 1) * length      # covers, no idle split
    assert 1 <= n <= MAX_GRID_Z
    # about SPLIT_POSITIONS each while the grid allows it
    default = ps * -(-SPLIT_POSITIONS // ps)
    if -(-cap // default) <= MAX_GRID_Z:
        assert length == default


def test_split_plan_reads_shapes_only():
    """The plan takes no tensor: the slots' positions stay on the card
    (no host read in the decode tick)."""
    params = list(inspect.signature(split_plan).parameters)
    assert params == ["capacity", "page_size"]
    assert split_plan(2080, 8) == (9, 256)


def _inputs(b, h, hkv, dh, cap, ps, pos, seed):
    rng = np.random.default_rng(seed)
    pps = cap // ps
    table = rng.permutation(np.arange(1, 1 + b * pps)).astype(
        np.int32).reshape(b, pps)
    f = np.float32
    return (torch.tensor(rng.standard_normal((b, 1, h, dh), f)),
            torch.tensor(rng.standard_normal((1 + b * pps, ps, hkv, dh), f)),
            torch.tensor(rng.standard_normal((1 + b * pps, ps, hkv, dh), f)),
            torch.tensor(table), torch.tensor(np.asarray(pos, np.int32)))


EDGES = {"one": [0, 96],
         "even": [0, 32, 64, 96],
         "ragged": [0, 1, 17, 18, 40, 95, 96],
         "empty": [0, 0, 10, 10, 10, 60, 96, 96]}


@pytest.mark.parametrize("window", [None, 1, 7, 50])
@pytest.mark.parametrize("edges", list(EDGES))
def test_plain_split_combine_equals_unsplit(edges, window):
    args = _inputs(4, 12, 3, 32, 96, 4, [0, 17, 63, 95], seed=3)
    want = paged_decode_attention_ref(*args, page_size=4, window=window)
    acc, m, l = paged_decode_partials_ref(*args, page_size=4,
                                          edges=EDGES[edges], window=window)
    assert acc.shape == (len(EDGES[edges]) - 1, 4, 12, 32)
    assert torch.equal(l == 0, m == -torch.inf)     # empty = (-inf, 0)
    got = paged_decode_combine_ref(acc, m, l, torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cap,ps", [(2080, 8), (40, 8), (300, 1)])
def test_plain_split_combine_on_the_plan(cap, ps):
    """The kernel's own split edges (from the plan) merge to the unsplit
    result, a slot at 0 and slots on the edges included."""
    n, length = split_plan(cap, ps)
    pos = [0, min(length, cap - 1), min(length - 1, cap - 1), cap - 1]
    args = _inputs(4, 10, 2, 32, cap, ps, pos, seed=4)
    edges = [min(z * length, cap) for z in range(n + 1)]
    for window in (None, 5, length):
        acc, m, l = paged_decode_partials_ref(*args, page_size=ps,
                                              edges=edges, window=window)
        got = paged_decode_combine_ref(acc, m, l, torch.float32)
        want = paged_decode_attention_ref(*args, page_size=ps,
                                          window=window)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_plain_combine_of_all_empty_rows_is_zero():
    acc = torch.full((3, 2, 4, 8), float("nan"))
    m = torch.full((3, 2, 4), -torch.inf)
    l = torch.zeros(3, 2, 4)
    m[1, 0], l[1, 0], acc[1, 0] = 0.5, 2.0, 1.0     # slot 0 has one split
    out = paged_decode_combine_ref(acc, m, l, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 1, 4, 8)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    torch.testing.assert_close(out[0].float(), torch.full((1, 4, 8), 0.5))
