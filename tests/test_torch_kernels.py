"""Port kernels vs the reference's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; those
are held against the reference's Pallas kernels run in interpret mode
(``repro.kernels``) on the grids of ``tests/test_kernels.py``.  The
``gpu`` cases hold each hand-written kernel against its plain version on
the card at the same grids plus the main paths' shapes (qwen2.5-14b,
minicpm3-4b, mamba2-780m); they skip here.

Tolerances: the reference's own (rtol = atol = 2e-5 in f32, 2e-2 in
bf16, ``tests/test_kernels.py:15-17``; for the SSD scan 1e-4 and 4e-2,
``:220-221``) — the two sides sum in different orders (XLA:CPU vs
PyTorch, or a kernel's online softmax vs the plain version's one-pass
softmax, or the SSD kernel's f32 sums vs the plain version's bf16
intermediates), and bf16 outputs may round one ulp apart.  On the card
a bf16 paged decode also bounds each (slot, head) output row's error by a
share of that row's norm (RMS over rows 1e-2, worst row 5e-2, as the
flash cases): a row that averages V over 2000 positions has typical
values near 0.04, about the elementwise 2e-2, so only the row bound sees
a 64-position tile left out (about 0.18 of the row's norm).  The bf16
MLA decode takes the same row bound, and the bf16 SSD scan is held row
by row (each (b, s, h) row of y) by the same numbers against its plain
version computed in f32 from the same bf16 inputs (``_ssd_rows_close``;
the bound's derivation is at ``chip_smoke.SSD_ROW_TOL``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (paged_decode_attention,
                                 paged_decode_attention_ref,
                                 paged_mla_decode_attention,
                                 paged_mla_decode_attention_ref, rms_norm,
                                 rms_norm_ref, ssd_scan, ssd_scan_ref)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRID = [(2, 4, 4, 32, 16, 4),         # MHA
        (3, 8, 2, 64, 32, 8),         # GQA group 4
        (2, 4, 1, 32, 16, 2),         # MQA
        (2, 6, 3, 16, 12, 1),         # page_size 1
        (1, 2, 2, 32, 8, 8)]          # single page covers the cache
RMS_SHAPES = [(128, 256), (4, 32, 512), (1, 64)]
MLA_GRID = [(2, 4, 32, 16, 16, 4),    # tests/test_kernels.py:140-144
            (3, 2, 16, 8, 12, 1),     # page_size 1
            (1, 8, 64, 32, 8, 8)]     # single page
MLA_SHAPE = (16, 40, 256, 32, 2080, 8)   # minicpm3-4b decode
SSD_GRID = [(1, 128, 2, 64, 32, 32),  # tests/test_kernels.py:205-209
            (2, 256, 4, 32, 64, 64),
            (1, 64, 1, 16, 16, 64)]   # single chunk
SSD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=4e-2, atol=4e-2)}
ROW_TOL = dict(rms=1e-2, worst=5e-2)


@pytest.fixture(scope="module")
def ref():
    """The reference side, imported here rather than at the top so the
    ``gpu`` cases also run where JAX is not installed (the card's
    machine)."""
    import jax.numpy as jnp

    from repro.kernels import paged_decode_attention, rms_norm
    return jnp, paged_decode_attention, rms_norm


@pytest.fixture(scope="module")
def jref():
    """The reference's MLA and SSD kernels (imported here, as above)."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import paged_mla_decode_attention, ssd_scan
    return jax, jnp, paged_mla_decode_attention, ssd_scan


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m gpu on the card)")
    return torch.device("cuda")


def _close(a, b, dtype):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL[dtype])


def _decode_close(got, want, dtype):
    """Elementwise tolerance, and in bf16 the row bound (ROW_TOL) over
    each (slot, head) output row."""
    g, w = got.float().cpu(), want.float().cpu()
    _close(g, w, dtype)
    if dtype == "bfloat16":
        n2 = w.square().sum(-1)
        r = (g - w).square().sum(-1)[n2 > 0] / n2[n2 > 0]
        assert r.mean().sqrt().item() <= ROW_TOL["rms"]
        assert r.max().sqrt().item() <= ROW_TOL["worst"]


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


def _mla_inputs(b, h, rkv, dr, cache_len, ps, seed, pos=None,
                garbage_rest=True):
    rng = np.random.default_rng(seed)
    if pos is None:
        pos = rng.integers(0, cache_len, b)
        pos[-1] = cache_len - 1
    pos = np.asarray(pos, np.int32)
    table, num_pages = _table(b, cache_len, ps, pos, garbage_rest)
    return (rng.standard_normal((b, 1, h, rkv), np.float32),
            rng.standard_normal((b, 1, h, dr), np.float32),
            rng.standard_normal((num_pages, ps, rkv), np.float32),
            rng.standard_normal((num_pages, ps, dr), np.float32),
            table, pos)


def _mla_torch(inputs, dtype, device="cpu"):
    return ([_to_torch(x, dtype, device) for x in inputs[:4]]
            + [torch.tensor(inputs[4], device=device),
               torch.tensor(inputs[5], device=device)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,rkv,dr,cache_len,ps",
                         MLA_GRID + [(2, 40, 256, 32, 24, 8)])
def test_paged_mla_plain_matches_pallas(b, h, rkv, dr, cache_len, ps,
                                        dtype, jref):
    _, jnp, jax_mla, _ = jref
    inputs = _mla_inputs(b, h, rkv, dr, cache_len, ps, seed=9)
    scale = (rkv + dr) ** -0.5
    want = jax_mla(*(jnp.asarray(x).astype(dtype) for x in inputs[:4]),
                   jnp.asarray(inputs[4]), jnp.asarray(inputs[5]),
                   page_size=ps, scale=scale, interpret=True)
    got = paged_mla_decode_attention(*_mla_torch(inputs, dtype),
                                     page_size=ps, scale=scale)
    assert tuple(got.shape) == (b, 1, h, rkv) and got.dtype == getattr(
        torch, dtype)
    _close(got.float(), np.asarray(want.astype(jnp.float32)), dtype)


def test_paged_mla_plain_garbage_and_future_pages(jref):
    """The poisoned garbage page never leaks; pages allocated past pos are
    masked (the reference's GQA edge cases, on the latent pools)."""
    _, jnp, jax_mla, _ = jref
    inputs = _mla_inputs(3, 4, 32, 16, 16, 4, seed=10, pos=[0, 5, 15])
    args = _mla_torch(inputs, "float32")
    clean = paged_mla_decode_attention(*args, page_size=4, scale=0.2)
    args[2][0], args[3][0] = 1e4, 1e4
    poisoned = paged_mla_decode_attention(*args, page_size=4, scale=0.2)
    assert torch.equal(clean, poisoned) and torch.isfinite(poisoned).all()
    inputs = _mla_inputs(2, 2, 16, 8, 16, 4, seed=11, pos=[2, 9],
                         garbage_rest=False)
    want = jax_mla(*(jnp.asarray(x) for x in inputs), page_size=4,
                   scale=0.2, interpret=True)
    got = paged_mla_decode_attention(*_mla_torch(inputs, "float32"),
                                     page_size=4, scale=0.2)
    _close(got, np.asarray(want), "float32")


def test_paged_mla_wrapper_takes_plain_only_on_cpu():
    args = _mla_torch(_mla_inputs(2, 4, 32, 16, 16, 4, seed=3), "float32")
    before = paged_mla_decode_attention.launches.value
    out = paged_mla_decode_attention(*args, page_size=4, scale=0.2)
    assert torch.equal(out, paged_mla_decode_attention_ref(
        *args, page_size=4, scale=0.2))
    assert paged_mla_decode_attention.launches.value == before
    with pytest.raises(RuntimeError, match="no kernel"):
        paged_mla_decode_attention(*[a.to("meta") for a in args],
                                   page_size=4, scale=0.2)


def _ssd_inputs(b, s, h, p, n, seed):
    """tests/test_kernels.py:211-216 with numpy draws."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1
    a = -np.exp(rng.standard_normal(h) * 0.3)
    bmat = rng.standard_normal((b, s, h, n), np.float32) * 0.5
    cmat = rng.standard_normal((b, s, h, n), np.float32) * 0.5
    return x, dt.astype(np.float32), a.astype(np.float32), bmat, cmat


def _ssd_torch(inputs, dtype, device="cpu"):
    x, dt, a, bmat, cmat = inputs
    return (_to_torch(x, dtype, device), torch.tensor(dt, device=device),
            torch.tensor(a, device=device), _to_torch(bmat, dtype, device),
            _to_torch(cmat, dtype, device))


def _ssd_close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **SSD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_GRID)
def test_ssd_plain_matches_pallas(b, s, h, p, n, chunk, dtype, jref):
    _, jnp, _, jax_ssd = jref
    inputs = _ssd_inputs(b, s, h, p, n, seed=4)
    x, dt, a, bmat, cmat = inputs
    y_j, h_j = jax_ssd(jnp.asarray(x).astype(dtype), jnp.asarray(dt),
                       jnp.asarray(a), jnp.asarray(bmat).astype(dtype),
                       jnp.asarray(cmat).astype(dtype), chunk=chunk,
                       interpret=True)
    y, hf = ssd_scan(*_ssd_torch(inputs, dtype), chunk=chunk)
    assert y.dtype == getattr(torch, dtype) and hf.dtype == torch.float32
    assert tuple(y.shape) == (b, s, h, p) and tuple(hf.shape) == (b, h, p, n)
    _ssd_close(y.float(), y_j.astype(jnp.float32), dtype)
    _ssd_close(hf, h_j, dtype)


def test_ssd_plain_state_carries_across_chunks(jref):
    """Chunk sizes 16, 32, 128 give the same scan (and the Pallas
    kernel's), tests/test_kernels.py:224-243."""
    _, jnp, _, jax_ssd = jref
    inputs = _ssd_inputs(1, 128, 2, 32, 32, seed=5)
    args = _ssd_torch(inputs, "float32")
    outs = [ssd_scan(*args, chunk=c) for c in (16, 32, 128)]
    for y, hf in outs[1:]:
        _ssd_close(y, outs[0][0], "float32")
        _ssd_close(hf, outs[0][1], "float32")
    y_j, _ = jax_ssd(*(jnp.asarray(x) for x in inputs), chunk=16,
                     interpret=True)
    _ssd_close(outs[0][0], y_j, "float32")


def test_ssd_wrapper_takes_plain_only_on_cpu():
    args = _ssd_torch(_ssd_inputs(1, 64, 2, 16, 16, seed=3), "float32")
    before = ssd_scan.launches.value
    y, hf = ssd_scan(*args, chunk=16)
    y_r, hf_r = ssd_scan_ref(*args, chunk=16)
    assert torch.equal(y, y_r) and torch.equal(hf, hf_r)
    assert ssd_scan.launches.value == before
    with pytest.raises(RuntimeError, match="no kernel"):
        ssd_scan(*[a.to("meta") for a in args], chunk=16)


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
    _decode_close(got, want, dtype)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MLA_GRID + [(3, 40, 256, 32, 40, 8),
                                              MLA_SHAPE])
def test_paged_mla_kernel_matches_plain(shape, dtype, cuda):
    ps = shape[-1]
    args = _mla_torch(_mla_inputs(*shape, seed=1), dtype, cuda)
    scale = (64 + 32) ** -0.5
    before = paged_mla_decode_attention.launches.value
    got = paged_mla_decode_attention(*args, page_size=ps, scale=scale)
    torch.cuda.synchronize()
    assert paged_mla_decode_attention.launches.value == before + 1
    want = paged_mla_decode_attention_ref(*args, page_size=ps, scale=scale)
    _decode_close(got, want, dtype)


@pytest.mark.gpu
def test_paged_mla_kernel_garbage_and_future_pages(cuda):
    args = _mla_torch(_mla_inputs(3, 4, 32, 16, 16, 4, seed=10,
                                  pos=[0, 5, 15]), "float32", cuda)
    clean = paged_mla_decode_attention(*args, page_size=4, scale=0.2)
    args[2][0], args[3][0] = 1e4, 1e4
    poisoned = paged_mla_decode_attention(*args, page_size=4, scale=0.2)
    assert torch.equal(clean, poisoned) and torch.isfinite(poisoned).all()
    args = _mla_torch(_mla_inputs(2, 2, 16, 8, 16, 4, seed=11, pos=[2, 9],
                                  garbage_rest=False), "float32", cuda)
    _close(paged_mla_decode_attention(*args, page_size=4, scale=0.2).cpu(),
           paged_mla_decode_attention_ref(*args, page_size=4,
                                          scale=0.2).cpu(), "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_GRID + [(1, 2048, 48, 64, 128, 256)])
def test_ssd_kernel_matches_plain(shape, dtype, cuda):
    *dims, chunk = shape
    args = _ssd_torch(_ssd_inputs(*dims, seed=4), dtype, cuda)
    before = ssd_scan.launches.value
    y, hf = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches.value == before + 1
    y_r, hf_r = ssd_scan_ref(*args, chunk=chunk)
    _ssd_close(y.float().cpu(), y_r.float().cpu(), dtype)
    _ssd_close(hf.cpu(), hf_r.float().cpu(), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("s,chunk", [(100, 32), (300, 256), (7, 4)])
def test_ssd_kernel_partial_last_chunk(s, chunk, cuda):
    """A short last chunk adds nothing past S: the kernel at ``chunk``
    equals the plain version over one chunk of all S positions."""
    args = _ssd_torch(_ssd_inputs(2, s, 3, 64, 128, seed=6), "float32", cuda)
    y, hf = ssd_scan(*args, chunk=chunk)
    y_r, hf_r = ssd_scan_ref(*args, chunk=s)
    _ssd_close(y.cpu(), y_r.cpu(), "float32")
    _ssd_close(hf.cpu(), hf_r.cpu(), "float32")


def _split_len(capacity, ps):
    from repro_torch.kernels.paged_attention import split_plan
    return split_plan(capacity, ps)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1, 3, 7, 100])
def test_paged_decode_kernel_window_bf16(window, cuda):
    args = _paged_case_cuda((3, 4, 2, 32, 24, 4), "bfloat16", cuda, seed=8)
    got = paged_decode_attention(*args, page_size=4, window=window)
    want = paged_decode_attention_ref(*args, page_size=4, window=window)
    _decode_close(got, want, "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 3, 300])
@pytest.mark.parametrize("shape", [(3, 4, 2, 32, 16, 4),
                                   (4, 40, 8, 128, 2080, 8)])
def test_paged_decode_kernel_garbage_page_bit_identical(shape, window, dtype,
                                                        cuda):
    """Page 0 poisoned with 1e4: nothing behind a masked position is read,
    so the output is bit-identical (split and one-split shapes)."""
    pos = [0, 5, 15] if shape[0] == 3 else [0, 255, 1000, 2079]
    args = _paged_case_cuda(shape, dtype, cuda, seed=10, pos=pos)
    ps = shape[-1]
    clean = paged_decode_attention(*args, page_size=ps, window=window)
    args[1][0] = 1e4
    args[2][0] = 1e4
    poisoned = paged_decode_attention(*args, page_size=ps, window=window)
    assert torch.equal(clean, poisoned) and torch.isfinite(poisoned).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 100, "split"])
def test_paged_decode_kernel_split_edges(window, dtype, cuda):
    """Positions at and around the split length (L - 1, L, L + 1, 2L),
    a slot at position 0, the last position, and windows that empty whole
    splits (100) or end on a split edge (L), at qwen2.5-14b's widths."""
    n_split, length = _split_len(2080, 8)
    assert n_split > 1
    pos = [length - 2, length - 1, length, 0, 2079, 2 * length - 1,
           2 * length, 1]
    w = length if window == "split" else window
    args = _paged_case_cuda((8, 40, 8, 128, 2080, 8), dtype, cuda, seed=12,
                            pos=pos)
    got = paged_decode_attention(*args, page_size=8, window=w)
    want = paged_decode_attention_ref(*args, page_size=8, window=w)
    _decode_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_one_split(dtype, cuda):
    """A table of one split's capacity: the split kernel writes the output
    itself (no combine)."""
    assert _split_len(200, 8)[0] == 1
    args = _paged_case_cuda((3, 10, 2, 128, 200, 8), dtype, cuda, seed=14,
                            pos=[0, 100, 199])
    got = paged_decode_attention(*args, page_size=8)
    want = paged_decode_attention_ref(*args, page_size=8)
    _decode_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_combine_kernel_matches_plain(dtype, cuda):
    """The combine kernel against its plain version on the split kernel's
    own partials; empty splits are (m = -inf, l = 0)."""
    from repro_torch.kernels.paged_attention import (
        paged_decode_combine, paged_decode_combine_ref,
        paged_decode_partials)
    n_split, length = _split_len(2080, 8)
    args = _paged_case_cuda((16, 40, 8, 128, 2080, 8), dtype, cuda, seed=13)
    acc, m, l = paged_decode_partials(*args, page_size=8, n_split=n_split,
                                      split_len=length, window=700)
    assert torch.equal(l == 0, m == -torch.inf)
    got = paged_decode_combine(acc, m, l, getattr(torch, dtype))
    want = paged_decode_combine_ref(acc, m, l, getattr(torch, dtype))
    _decode_close(got, want, dtype)
    full = paged_decode_attention_ref(*args, page_size=8, window=700)
    _decode_close(got, full, dtype)


# ------------------------------- the chunk-parallel SSD scan (on the card)
def _f32_inputs(args):
    x, dt, a, bmat, cmat = args
    return x.float(), dt, a, bmat.float(), cmat.float()


def _plain_scan(args, chunk):
    """The plain chunk-parallel decomposition in f32: (y, h_final)."""
    from repro_torch.kernels.ssd_chunk import (ssd_chunk_output_ref,
                                               ssd_chunk_states_ref,
                                               ssd_state_pass_ref)
    f = _f32_inputs(args)
    h_prev, hf = ssd_state_pass_ref(*ssd_chunk_states_ref(*f, chunk=chunk))
    return ssd_chunk_output_ref(*f, h_prev, chunk=chunk), hf


def _rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _ssd_rows_close(got, want):
    """Each (b, s, h) row of y: error over the row's norm, RMS over rows
    and worst row (``ROW_TOL``)."""
    g, w = got.float().cpu(), want.float().cpu()
    n2 = w.square().sum(-1)
    r = (g - w).square().sum(-1)[n2 > 0] / n2[n2 > 0]
    assert r.mean().sqrt().item() <= ROW_TOL["rms"]
    assert r.max().sqrt().item() <= ROW_TOL["worst"]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 300, 3, 64, 128, 256),
                                   (2, 200, 4, 16, 32, 64),
                                   (1, 2048, 48, 64, 128, 256)])
def test_ssd_kernel_phases_match_plain(shape, cuda):
    """Each bf16 phase against its plain version in f32 on the same
    inputs: the chunk states (bf16 rounding of x * w: 1e-2 of the states'
    norm), the state pass and the chunk output on the plain states, and
    the composed scan, y row by row."""
    from repro_torch.kernels.ssd_chunk import (
        ssd_chunk_output, ssd_chunk_output_ref, ssd_chunk_states,
        ssd_chunk_states_ref, ssd_state_pass, ssd_state_pass_ref)
    *dims, chunk = shape
    args = _ssd_torch(_ssd_inputs(*dims, seed=4), "bfloat16", cuda)
    f = _f32_inputs(args)
    states, decay = ssd_chunk_states(*args, chunk=chunk)
    states_r, decay_r = ssd_chunk_states_ref(*f, chunk=chunk)
    torch.testing.assert_close(decay, decay_r, rtol=1e-5, atol=1e-4)
    assert _rel(states, states_r) <= 1e-2
    h_prev, hf = ssd_state_pass(states_r.clone(), decay_r)
    h_prev_r, hf_r = ssd_state_pass_ref(states_r, decay_r)
    torch.testing.assert_close(h_prev, h_prev_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hf, hf_r, rtol=1e-5, atol=1e-5)
    y = ssd_chunk_output(*args, h_prev_r.contiguous(), chunk=chunk)
    _ssd_rows_close(y, ssd_chunk_output_ref(*f, h_prev_r, chunk=chunk))
    before = ssd_scan.launches.value
    y, hf = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches.value == before + 1
    y_r, hf_r = _plain_scan(args, chunk)
    _ssd_rows_close(y, y_r)
    assert _rel(hf, hf_r) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_reads_group_broadcast_in_place(dtype, cuda):
    """x, B and C as the model hands them over: views of one (B, S, C)
    activation, B and C one group broadcast to every head (head stride
    0).  The kernel reads them in place and gives what it gives on
    per-head contiguous copies, bit for bit."""
    b, s, h, p, n = 2, 300, 4, 64, 128
    rng = np.random.default_rng(8)
    conv = torch.tensor(rng.standard_normal((b, s, h * p + 2 * n),
                                            np.float32) * 0.5,
                        device=cuda).to(getattr(torch, dtype))
    x = conv[..., :h * p].unflatten(-1, (h, p))
    bc = conv[..., h * p:].unflatten(-1, (2, 1, n))
    bmat = bc[:, :, 0].expand(b, s, h, n)
    cmat = bc[:, :, 1].expand(b, s, h, n)
    assert bmat.stride(2) == 0 and not x.is_contiguous()
    _, dt, a, _, _ = _ssd_torch(_ssd_inputs(b, s, h, p, n, seed=8),
                                "float32", cuda)
    y, hf = ssd_scan(x, dt, a, bmat, cmat, chunk=64)
    y2, hf2 = ssd_scan(x.contiguous(), dt, a, bmat.contiguous(),
                       cmat.contiguous(), chunk=64)
    assert torch.equal(y, y2) and torch.equal(hf, hf2)
    y_r, hf_r = _plain_scan((x, dt, a, bmat, cmat), 64)
    if dtype == "float32":
        _ssd_close(y.cpu(), y_r.cpu(), dtype)
        _ssd_close(hf.cpu(), hf_r.cpu(), dtype)
    else:
        _ssd_rows_close(y, y_r)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [1, 5, 16, 64, 100, 256])
def test_ssd_kernel_chunk_sizes(chunk, dtype, cuda):
    """Chunk lengths 1..256, most with a short last chunk, against the
    plain decomposition at the same chunk."""
    args = _ssd_torch(_ssd_inputs(1, 200, 2, 32, 64, seed=7), dtype, cuda)
    y, hf = ssd_scan(*args, chunk=chunk)
    y_r, hf_r = _plain_scan(args, chunk)
    if dtype == "float32":
        _ssd_close(y.cpu(), y_r.cpu(), dtype)
        _ssd_close(hf.cpu(), hf_r.cpu(), dtype)
    else:
        _ssd_rows_close(y, y_r)
        assert _rel(hf, hf_r) <= 1e-2


# -------------------------------------- the split MLA decode (on the card)
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_mla_kernel_split_edges(dtype, cuda):
    """Positions at and around the split length, a slot at 0 and the last
    position, at minicpm3-4b's widths."""
    n_split, length = _split_len(2080, 8)
    assert n_split > 1
    pos = [length - 2, length - 1, length, 0, 2079, 2 * length - 1,
           2 * length, 1]
    args = _mla_torch(_mla_inputs(8, 40, 256, 32, 2080, 8, seed=12,
                                  pos=pos), dtype, cuda)
    kw = dict(page_size=8, scale=(64 + 32) ** -0.5)
    _decode_close(paged_mla_decode_attention(*args, **kw),
                  paged_mla_decode_attention_ref(*args, **kw), dtype)


@pytest.mark.gpu
def test_paged_mla_split_and_combine_match_plain(cuda):
    """The bf16 split kernel's partials: empty splits are (m = -inf, l =
    0) where the plain partials are empty; the shared combine kernel on
    them matches its plain version and the unsplit plain decode."""
    from repro_torch.kernels.paged_attention import (
        paged_decode_combine, paged_decode_combine_ref,
        paged_mla_decode_partials, paged_mla_decode_partials_ref)
    n_split, length = _split_len(2080, 8)
    args = _mla_torch(_mla_inputs(*MLA_SHAPE, seed=13), "bfloat16", cuda)
    kw = dict(page_size=8, scale=(64 + 32) ** -0.5)
    acc, m, l = paged_mla_decode_partials(*args, n_split=n_split,
                                          split_len=length, **kw)
    edges = [min(z * length, 2080) for z in range(n_split + 1)]
    _, m_r, l_r = paged_mla_decode_partials_ref(*args, edges=edges, **kw)
    assert torch.equal(l == 0, m == -torch.inf)
    assert torch.equal(l == 0, l_r == 0)
    got = paged_decode_combine(acc, m, l, torch.bfloat16)
    _decode_close(got, paged_decode_combine_ref(acc, m, l, torch.bfloat16),
                  "bfloat16")
    _decode_close(got, paged_mla_decode_attention_ref(*args, **kw),
                  "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 4, 32, 16, 16, 4),
                                   (4, 40, 256, 32, 2080, 8)])
def test_paged_mla_kernel_garbage_page_bit_identical_bf16(shape, cuda):
    """Page 0 poisoned with 1e4 in bf16 (one-split and split shapes):
    nothing behind a masked position is read."""
    pos = [0, 5, 15] if shape[0] == 3 else [0, 255, 1000, 2079]
    args = _mla_torch(_mla_inputs(*shape, seed=10, pos=pos), "bfloat16",
                      cuda)
    kw = dict(page_size=shape[-1], scale=0.2)
    clean = paged_mla_decode_attention(*args, **kw)
    args[2][0], args[3][0] = 1e4, 1e4
    poisoned = paged_mla_decode_attention(*args, **kw)
    assert torch.equal(clean, poisoned) and torch.isfinite(poisoned).all()
