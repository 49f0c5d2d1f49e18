"""Port flash attention (``repro_torch.kernels.flash_attention``) vs the
reference's Pallas kernel and its oracle.

On the CPU the port's wrapper takes its plain PyTorch version; that is
held against the reference's ``flash_attention`` in Pallas interpret mode
and against ``flash_attention_ref`` on the grid of
``tests/test_kernels.py:26-77`` (MHA / MQA / GQA, cross lengths, D 32,
windows 16 / 64 / 100, non-causal) in f32 and bf16, plus lengths that are
no multiple of a tile, every GQA group size of the registry, and rows
with no valid key.  The ``gpu`` cases hold the CUDA kernel against its
plain version on the card at the same grid plus the serve paths' prefill
shapes (qwen2.5-14b, mixtral-8x7b); they skip here.

Tolerances: the reference's own (rtol = atol = 2e-5 in f32, 2e-2 in
bf16, ``tests/test_kernels.py:15-17``) — the sides sum in different
orders (XLA:CPU vs PyTorch, the kernel's online softmax vs a one-pass
softmax), and the bf16 kernel rounds P to bf16 before the P.V product.
On the card a bf16 case also bounds each output row's error by a share
of that row's norm (RMS over rows 1e-2, worst row 5e-2): at long rows a
typical output value is as small as the elementwise 2e-2, and bf16
rounding moves a row by a few 1e-3 of its norm.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, flash_attention_ref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# (b, sq, sk, h, hkv, d): tests/test_kernels.py:28-33
GRID = [(1, 128, 128, 2, 2, 64),      # MHA square
        (2, 256, 256, 4, 1, 64),      # MQA
        (1, 128, 256, 8, 2, 128),     # GQA, cross lengths
        (1, 64, 64, 2, 2, 32)]        # small head_dim
# lengths no multiple of any tile, and the registry's group sizes
ODD = [(2, 100, 100, 4, 2, 64), (1, 300, 300, 6, 1, 128),
       (1, 77, 200, 4, 4, 32)]
GROUPS = (1, 2, 4, 5, 6, 8, 12)
ROW_TOL = dict(rms=1e-2, worst=5e-2)


@pytest.fixture(scope="module")
def jref():
    """The reference side, imported here rather than at the top so the
    ``gpu`` cases also run where JAX is not installed (the card's
    machine)."""
    import jax.numpy as jnp

    from repro.kernels import flash_attention as jflash
    from repro.kernels import flash_attention_ref as jflash_ref
    return jnp, jflash, jflash_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m gpu on the card)")
    return torch.device("cuda")


def _inputs(b, sq, sk, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), np.float32),
            rng.standard_normal((b, sk, hkv, d), np.float32),
            rng.standard_normal((b, sk, hkv, d), np.float32))


def _torch(arrays, dtype, device="cpu"):
    return [torch.tensor(a, device=device).to(getattr(torch, dtype))
            for a in arrays]


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL[dtype])


def _against_reference(jref, arrays, dtype, block, **kw):
    """The port's plain version against the Pallas kernel (interpret
    mode) and the reference's oracle on the same inputs."""
    jnp, jflash, jflash_ref = jref
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrays)
    pallas = jflash(jq, jk, jv, block_q=block, block_k=block,
                    interpret=True, **kw)
    oracle = jflash_ref(jq, jk, jv, **kw)
    got = flash_attention(*_torch(arrays, dtype), **kw)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == arrays[0].shape
    _close(got.float(), pallas.astype(jnp.float32), dtype)
    _close(got.float(), oracle.astype(jnp.float32), dtype)
    return got


# ------------------------------------------------------ plain vs Pallas (CPU)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,hkv,d", GRID)
def test_flash_plain_matches_pallas(b, sq, sk, h, hkv, d, dtype, jref):
    _against_reference(jref, _inputs(b, sq, sk, h, hkv, d, seed=0), dtype,
                       64, causal=True)


@pytest.mark.parametrize("window", [16, 64, 100])
def test_flash_plain_sliding_window(window, jref):
    _against_reference(jref, _inputs(1, 128, 128, 2, 2, 64, seed=1),
                       "float32", 32, causal=True, window=window)


def test_flash_plain_noncausal(jref):
    _against_reference(jref, _inputs(2, 64, 128, 2, 2, 64, seed=2),
                       "float32", 64, causal=False)


@pytest.mark.parametrize("b,sq,sk,h,hkv,d", ODD)
def test_flash_plain_odd_lengths(b, sq, sk, h, hkv, d, jref):
    """Lengths no multiple of any tile (one Pallas block spans them)."""
    _against_reference(jref, _inputs(b, sq, sk, h, hkv, d, seed=3),
                       "float32", max(sq, sk), causal=True, window=50)


@pytest.mark.parametrize("group", GROUPS)
def test_flash_plain_gqa_groups(group, jref):
    """Flat head h reads kv head h // group, for every group size of the
    registry."""
    _against_reference(jref, _inputs(1, 64, 64, 2 * group, 2, 32,
                                      seed=group), "float32", 32,
                       causal=True)


def test_flash_plain_rows_without_a_valid_key_are_zero(jref):
    """Sq > Sk + window - 1: causal rows i >= Sk + window - 1 see no key
    (keys in (i - window, min(i, Sk - 1)]) and give exact zeros, as the
    reference kernel's do."""
    sq, sk, window = 64, 16, 8
    got = _against_reference(jref, _inputs(1, sq, sk, 4, 2, 32, seed=4),
                             "float32", 16, causal=True, window=window)
    dead = got[:, sk + window - 1:]
    assert dead.shape[1] > 0 and torch.equal(dead, torch.zeros_like(dead))
    assert got[:, :sk + window - 1].abs().amax(dim=(0, 2, 3)).min() > 0


def test_flash_wrapper_takes_plain_only_on_cpu():
    args = _torch(_inputs(1, 32, 32, 4, 2, 32, seed=5), "float32")
    before = flash_attention.launches.value
    out = flash_attention(*args, window=8)
    assert torch.equal(out, flash_attention_ref(*args, window=8))
    assert flash_attention.launches.value == before          # no launch
    # meta holds no data: the plain version's pass over shapes, no launch
    meta = flash_attention(*[a.to("meta") for a in args], window=8)
    assert meta.device.type == "meta" and meta.shape == out.shape
    assert flash_attention.launches.value == before


def test_flash_plain_chunks_queries():
    """The plain version goes a chunk of queries at a time (bounded f32
    scores); chunk borders change nothing, and it computes the function of
    the port's ``qchunk_attention`` (the reference model's prefill)."""
    from repro_torch.models.attention import qchunk_attention

    args = _torch(_inputs(2, 600, 600, 8, 2, 64, seed=6), "float32")
    whole = flash_attention_ref(*args, window=100, chunk=600)
    for chunk in (64, 512):
        torch.testing.assert_close(
            flash_attention_ref(*args, window=100, chunk=chunk), whole,
            rtol=0, atol=1e-6)
    torch.testing.assert_close(qchunk_attention(*args, window=100), whole,
                               **TOL["float32"])


# --------------------------------------------- kernel vs plain (on the card)
def _kernel_vs_plain(shape, dtype, device, seed=0, **kw):
    args = _torch(_inputs(*shape, seed=seed), dtype, device)
    before = flash_attention.launches.value
    got = flash_attention(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches.value == before + 1
    want = flash_attention_ref(*args, **kw)
    _close(got.float().cpu(), want.float().cpu(), dtype)
    if dtype == "bfloat16":
        rms, worst = _row_err(got, want)
        assert rms <= ROW_TOL["rms"] and worst <= ROW_TOL["worst"]
    return got


def _row_err(got, want):
    """(RMS over rows, worst row) of ||got - want|| / ||want|| per output
    row (the last axis), rows where ``want`` is all zero left out."""
    g, w = got.float(), want.float()
    n2 = w.square().sum(-1)
    r = (g - w).square().sum(-1)[n2 > 0] / n2[n2 > 0]
    return r.mean().sqrt().item(), r.max().sqrt().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GRID + ODD + [
    (1, 2048, 2048, 40, 8, 128),      # qwen2.5-14b prefill
    (4, 512, 512, 40, 8, 128)])
def test_flash_kernel_matches_plain(shape, dtype, cuda):
    _kernel_vs_plain(shape, dtype, cuda, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (1, 2048, 2048, 32, 32, 64),      # musicgen-large: MHA, D 64
    (1, 2304, 2304, 16, 8, 128)])     # internvl2-2b: 256 patches + 2048
def test_flash_kernel_at_the_frontends_prefill_shapes(shape, dtype, cuda):
    """The frontends' longest prefills, held row by row; planted: every
    query head reads the next KV head (rows mixed up), which must break
    the row bound."""
    _kernel_vs_plain(shape, dtype, cuda)
    q, k, v = _torch(_inputs(*shape, seed=0), dtype, cuda)
    bad = flash_attention(q, k.roll(1, dims=2).contiguous(),
                          v.roll(1, dims=2).contiguous())
    rms, worst = _row_err(bad, flash_attention_ref(q, k, v))
    assert rms > ROW_TOL["rms"] or worst > ROW_TOL["worst"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [1, 16, 64, 100])
def test_flash_kernel_window(window, dtype, cuda):
    _kernel_vs_plain((2, 300, 300, 8, 2, 128), dtype, cuda, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", GROUPS)
def test_flash_kernel_gqa_groups(group, dtype, cuda):
    _kernel_vs_plain((2, 130, 130, 2 * group, 2, 64), dtype, cuda,
                     seed=group, window=40)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_noncausal_and_dead_rows(dtype, cuda):
    _kernel_vs_plain((2, 64, 128, 4, 2, 64), dtype, cuda, causal=False)
    _kernel_vs_plain((2, 64, 128, 4, 2, 64), dtype, cuda, causal=False,
                     window=30)
    got = _kernel_vs_plain((1, 200, 40, 4, 2, 32), dtype, cuda, window=16)
    dead = got[:, 40 + 16 - 1:]
    assert torch.equal(dead, torch.zeros_like(dead))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,window", [
    ((2, 24, 24, 4, 4, 16), None),    # the tiny configs' prefill
    ((1, 300, 300, 4, 2, 16), 40)])
def test_flash_kernel_f32_tiny_head_dim(shape, window, cuda):
    """f32 at head dim 16, the tiny configs' (``--tiny`` and the examples
    on the card); bf16 takes 32, 64 and 128 only."""
    _kernel_vs_plain(shape, "float32", cuda, window=window)
    args = _torch(_inputs(*shape, seed=0), "bfloat16", cuda)
    with pytest.raises(ValueError, match="head_dim 16"):
        flash_attention(*args)


@pytest.mark.gpu
def test_flash_kernel_mixtral_prefill_shape(cuda):
    """mixtral-8x7b's longest prefill: 8192 positions, window 4096, 32 / 8
    heads."""
    _kernel_vs_plain((1, 8192, 8192, 32, 8, 128), "bfloat16", cuda,
                     window=4096)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [127, 128, 129, 255])
def test_flash_kernel_lengths_around_the_tiles(sq, dtype, cuda):
    """Lengths at and around the 128-row query tile and 64-key tile."""
    _kernel_vs_plain((2, sq, sq, 8, 2, 128), dtype, cuda)
    _kernel_vs_plain((1, sq, sq, 4, 4, 64), dtype, cuda, window=64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sk", [64, 128, 65])
def test_flash_kernel_one_and_two_key_tiles(sk, dtype, cuda):
    """Query tiles whose loop runs over exactly one or two key tiles (the
    ring's prologue and epilogue without a steady state)."""
    _kernel_vs_plain((1, 128, sk, 8, 2, 128), dtype, cuda, causal=False)
    _kernel_vs_plain((1, sk, sk, 8, 2, 128), dtype, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_more_keys_than_queries_noncausal(dtype, cuda):
    _kernel_vs_plain((2, 100, 700, 8, 2, 128), dtype, cuda, causal=False)
    _kernel_vs_plain((1, 129, 1000, 4, 1, 64), dtype, cuda, causal=False,
                     window=200)


@pytest.mark.gpu
@pytest.mark.parametrize("group", GROUPS)
def test_flash_kernel_gqa_groups_d128(group, cuda):
    """Every group size of the registry at D 128 in bf16, through the
    kernel's h / (H / Hkv) kv-head index: causal and windowed, lengths
    off the tiles."""
    _kernel_vs_plain((2, 203, 203, 2 * group, 2, 128), "bfloat16", cuda,
                     seed=group)
    _kernel_vs_plain((1, 150, 150, 3 * group, 3, 128), "bfloat16", cuda,
                     seed=group, window=37)
