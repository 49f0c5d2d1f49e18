"""Port kernels vs the reference's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; those
are held against the reference's Pallas kernels run in interpret mode
(``repro.kernels``) on the grids of ``tests/test_kernels.py``.  The
``gpu`` cases hold each hand-written kernel against its plain version on
the card at the same grids plus the qwen2.5-14b shapes; they skip here.

Tolerances: the reference's own (rtol = atol = 2e-5 in f32, 2e-2 in
bf16, ``tests/test_kernels.py:15-17``) — the two sides sum in different
orders (XLA:CPU vs PyTorch, or the kernel's online softmax vs the plain
version's one-pass softmax), and bf16 outputs may round one ulp apart.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (paged_decode_attention,
                                 paged_decode_attention_ref, rms_norm,
                                 rms_norm_ref)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRID = [(2, 4, 4, 32, 16, 4),         # MHA
        (3, 8, 2, 64, 32, 8),         # GQA group 4
        (2, 4, 1, 32, 16, 2),         # MQA
        (2, 6, 3, 16, 12, 1),         # page_size 1
        (1, 2, 2, 32, 8, 8)]          # single page covers the cache
RMS_SHAPES = [(128, 256), (4, 32, 512), (1, 64)]


@pytest.fixture(scope="module")
def ref():
    """The reference side, imported here rather than at the top so the
    ``gpu`` cases also run where JAX is not installed (the card's
    machine)."""
    import jax.numpy as jnp

    from repro.kernels import paged_decode_attention, rms_norm
    return jnp, paged_decode_attention, rms_norm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m gpu on the card)")
    return torch.device("cuda")


def _close(a, b, dtype):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL[dtype])


def _to_torch(x, dtype, device="cpu"):
    return torch.tensor(x, device=device).to(getattr(torch, dtype))


def _table(b, cache_len, ps, pos, garbage_rest=True):
    """Block table covering each slot's pos; the rest on garbage page 0
    (or allocated ahead of pos) — tests/test_kernels.py:_paged_table."""
    pps = cache_len // ps
    table = np.zeros((b, pps), np.int32)
    nxt = 1
    for i in range(b):
        n = -(-(int(pos[i]) + 1) // ps)
        stop = n if garbage_rest else pps
        for p in range(stop):
            table[i, p] = nxt
            nxt += 1
    return table, 1 + b * pps


def _paged_inputs(b, h, hkv, dh, cache_len, ps, seed, pos=None,
                  garbage_rest=True):
    rng = np.random.default_rng(seed)
    if pos is None:
        pos = rng.integers(0, cache_len, b)
        pos[0] = cache_len - 1            # full slot rides every page
    pos = np.asarray(pos, np.int32)
    table, num_pages = _table(b, cache_len, ps, pos, garbage_rest)
    q = rng.standard_normal((b, 1, h, dh), np.float32)
    kp = rng.standard_normal((num_pages, ps, hkv, dh), np.float32)
    vp = rng.standard_normal((num_pages, ps, hkv, dh), np.float32)
    return q, kp, vp, table, pos


def _both(ref, inputs, dtype, ps, window=None):
    jnp, jax_paged, _ = ref
    q, kp, vp, table, pos = inputs
    want = jax_paged(*(jnp.asarray(x).astype(dtype) for x in (q, kp, vp)),
                     jnp.asarray(table), jnp.asarray(pos), page_size=ps,
                     window=window, interpret=True)
    got = paged_decode_attention(
        _to_torch(q, dtype), _to_torch(kp, dtype), _to_torch(vp, dtype),
        torch.tensor(table), torch.tensor(pos), page_size=ps, window=window)
    return got, np.asarray(want.astype(jnp.float32))


# ------------------------------------------------------ plain vs Pallas (CPU)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,dh,cache_len,ps", GRID)
def test_paged_decode_plain_matches_pallas(b, h, hkv, dh, cache_len, ps,
                                           dtype, ref):
    got, want = _both(ref, _paged_inputs(b, h, hkv, dh, cache_len, ps,
                                         seed=7), dtype, ps)
    assert tuple(got.shape) == (b, 1, h, dh) and got.dtype == getattr(
        torch, dtype)
    _close(got.float(), want, dtype)


@pytest.mark.parametrize("window", [1, 3, 7, 100])
def test_paged_decode_plain_window_matches_pallas(window, ref):
    got, want = _both(ref, _paged_inputs(3, 4, 2, 32, 24, 4, seed=8),
                      "float32", 4, window=window)
    _close(got, want, "float32")


def test_paged_decode_plain_garbage_page_is_inert(ref):
    q, kp, vp, table, pos = _paged_inputs(3, 4, 2, 32, 16, 4, seed=10,
                                          pos=[0, 5, 15])
    clean, want = _both(ref, (q, kp, vp, table, pos), "float32", 4)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0] = 1e4
    vp2[0] = 1e4
    poisoned, _ = _both(ref, (q, kp2, vp2, table, pos), "float32", 4)
    assert torch.equal(poisoned, clean)
    assert torch.isfinite(poisoned).all()
    _close(clean, want, "float32")


def test_paged_decode_plain_future_pages_masked(ref):
    got, want = _both(ref, _paged_inputs(2, 2, 2, 16, 16, 4, seed=11,
                                         pos=[2, 9], garbage_rest=False),
                      "float32", 4)
    _close(got, want, "float32")


def test_paged_decode_wrapper_takes_plain_only_on_cpu():
    inputs = _paged_inputs(2, 4, 2, 32, 16, 4, seed=3)
    args = [_to_torch(x, "float32") for x in inputs[:3]] + \
        [torch.tensor(inputs[3]), torch.tensor(inputs[4])]
    before = paged_decode_attention.launches.value
    out = paged_decode_attention(*args, page_size=4)
    assert torch.equal(out, paged_decode_attention_ref(*args, page_size=4))
    assert paged_decode_attention.launches.value == before   # no launch
    with pytest.raises(RuntimeError, match="no kernel"):
        paged_decode_attention(*[a.to("meta") for a in args], page_size=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rms_norm_plain_matches_pallas(shape, dtype, ref):
    jnp, _, jax_rms_norm = ref
    rng = np.random.default_rng(6)
    x = rng.standard_normal(shape, np.float32)
    w = rng.standard_normal(shape[-1], np.float32) * 0.1 + 1.0
    want = jax_rms_norm(jnp.asarray(x).astype(dtype), jnp.asarray(w),
                        interpret=True)
    got = rms_norm(_to_torch(x, dtype), torch.tensor(w))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    _close(got.float(), np.asarray(want.astype(jnp.float32)), dtype)


# --------------------------------------------- kernel vs plain (on the card)
def _paged_case_cuda(shape, dtype, device, seed, **kw):
    q, kp, vp, table, pos = _paged_inputs(*shape, seed=seed, **kw)
    return ([_to_torch(x, dtype, device) for x in (q, kp, vp)]
            + [torch.tensor(table, device=device),
               torch.tensor(pos, device=device)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GRID + [
    (3, 10, 2, 64, 40, 8), (3, 12, 2, 128, 40, 8), (3, 24, 2, 128, 40, 8),
    (16, 40, 8, 128, 2080, 8)])           # groups 5, 6, 12; qwen decode
def test_paged_decode_kernel_matches_plain(shape, dtype, cuda):
    args = _paged_case_cuda(shape, dtype, cuda, seed=1)
    ps = shape[-1]
    before = paged_decode_attention.launches.value
    got = paged_decode_attention(*args, page_size=ps)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches.value == before + 1
    want = paged_decode_attention_ref(*args, page_size=ps)
    _close(got.float().cpu(), want.float().cpu(), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1, 3, 7, 100])
def test_paged_decode_kernel_window(window, cuda):
    args = _paged_case_cuda((3, 4, 2, 32, 24, 4), "float32", cuda, seed=8)
    got = paged_decode_attention(*args, page_size=4, window=window)
    want = paged_decode_attention_ref(*args, page_size=4, window=window)
    _close(got.cpu(), want.cpu(), "float32")


@pytest.mark.gpu
def test_paged_decode_kernel_garbage_and_future_pages(cuda):
    args = _paged_case_cuda((3, 4, 2, 32, 16, 4), "float32", cuda, seed=10,
                            pos=[0, 5, 15])
    clean = paged_decode_attention(*args, page_size=4)
    args[1][0] = 1e4
    args[2][0] = 1e4
    poisoned = paged_decode_attention(*args, page_size=4)
    assert torch.equal(clean, poisoned) and torch.isfinite(poisoned).all()
    args = _paged_case_cuda((2, 2, 2, 16, 16, 4), "float32", cuda, seed=11,
                            pos=[2, 9], garbage_rest=False)
    _close(paged_decode_attention(*args, page_size=4).cpu(),
           paged_decode_attention_ref(*args, page_size=4).cpu(), "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_SHAPES + [(16, 1, 5120),
                                                (16 * 2048, 5120)])
def test_rms_norm_kernel_matches_plain(shape, dtype, cuda):
    rng = np.random.default_rng(6)
    x = _to_torch(rng.standard_normal(shape, np.float32), dtype, cuda)
    w = torch.tensor(rng.standard_normal(shape[-1], np.float32) * 0.1 + 1,
                     device=cuda)
    before = rms_norm.launches.value
    got = rms_norm(x, w)
    torch.cuda.synchronize()
    assert rms_norm.launches.value == before + 1
    _close(got.float().cpu(), rms_norm_ref(x, w).float().cpu(), dtype)
