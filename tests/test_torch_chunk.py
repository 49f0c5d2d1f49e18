"""Chunked prefill in the port (``steps.make_prefill_chunk_step``, the
"prefill_chunk" mode of ``models.lm.forward``) against the reference's,
and the repair of prefill at lengths that do not split into equal chunks
(``models.attention.qchunk_attention``, ``models.ssm.ssd_chunked``).

CPU, f32, the tiny configs; weights from the reference's ``init_params``
handed over through ``repro_torch.params``.  Tolerance: rtol 1e-4 / atol
1e-5, as in ``tests/test_torch_model.py`` — XLA:CPU and PyTorch's CPU
GEMMs sum in different orders, and the difference grows through the
layers.  The port's own chunked logits are held to its one-shot prefill
at the same tolerance (``full_attention`` over a padded key extent
against the flash plain version: the same rows, summed in other orders).

The repair: where a length splits into equal chunks the port keeps the
reference's split and is held to the reference; where it does not (1025
or 1537 positions at chunk 512, 17 at chunk 8) the reference asserts and
the port takes a short last chunk, held to ``full_attention`` (every
query row sees the same keys however the rows are grouped: rtol 1e-5 /
atol 1e-6, the summation order of a batched product) and, for the SSD
scan, to the same scan in one chunk (chunk invariance: the exponentials
of cumulative sums round differently per chunk, 1e-4 as the reference's
SSD tests allow, ``tests/test_kernels.py:220-221``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.configs import get
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import tree_leaves
from repro_torch.params import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-5)
ROW_TOL = dict(rtol=1e-5, atol=1e-6)
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
B, PLEN, CACHE_LEN = 2, 13, 20


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.fixture(scope="module", params=["qwen2.5-14b", "minicpm3-4b"])
def model(request):
    cfg = get(request.param).tiny()
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (B, PLEN)).astype(np.int32)
    jstep = jax.jit(jsteps.make_prefill_chunk_step(cfg, None, CACHE_LEN),
                    static_argnames=("attn_extent", "want_logits"))
    return cfg, jp, tp, toks, jstep


@pytest.mark.parametrize("extent", [False, True])
@pytest.mark.parametrize("chunk", [1, 3, 4, 12])
def test_chunk_step_matches_reference(model, chunk, extent):
    """Chunks of ``chunk`` tokens (13 = a ragged last chunk at 3, 4 and
    12), each attending over the full cache or over the engine's extent
    bucket: row caches and last logits equal the reference's, and the
    logits equal the port's one-shot prefill."""
    cfg, jp, tp, toks, jstep = model
    step = tsteps.make_prefill_chunk_step(cfg, CACHE_LEN)
    rows = tlm.init_cache(cfg, B, CACHE_LEN, torch.float32, "cpu")
    jrows = jlm.init_cache(cfg, B, CACHE_LEN, jnp.float32)
    for c0 in range(0, PLEN, chunk):
        c1 = min(c0 + chunk, PLEN)
        ext = min(CACHE_LEN, -(-c1 // chunk) * chunk) if extent else None
        last = c1 >= PLEN
        rows, lg = step(tp, rows, torch.tensor(toks[:, c0:c1]), c0,
                        attn_extent=ext, want_logits=last)
        jrows, jlg = jstep(jp, jrows, jnp.asarray(toks[:, c0:c1]),
                           jnp.int32(c0), None, attn_extent=ext,
                           want_logits=last)
        assert (lg is None) == (not last) == (jlg is None)
    _close(lg.numpy(), jlg)
    assert int(rows["pos"]) == int(jrows["pos"]) == PLEN
    tl, jl = tree_leaves(rows["blocks"]), jax.tree.leaves(jrows["blocks"])
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        _close(t.numpy(), j)
    _, one = tsteps.make_prefill_step(cfg, cache_len=CACHE_LEN)(
        tp, torch.tensor(toks))
    _close(lg.numpy(), one.numpy())


def test_chunk_keeps_every_cache_leaf_in_place(model):
    """The in-place contract of a cache-updating mode: same tensors, same
    shapes and dtypes, ``pos`` advanced to the chunk's end."""
    cfg, _, tp, toks, _ = model
    step = tsteps.make_prefill_chunk_step(cfg, CACHE_LEN)
    rows = tlm.init_cache(cfg, B, CACHE_LEN, torch.float32, "cpu")
    before = [t.data_ptr() for t in tree_leaves(rows["blocks"])]
    out, lg = step(tp, rows, torch.tensor(toks[:, :5]), 0, want_logits=False)
    assert lg is None and int(out["pos"]) == 5
    assert [t.data_ptr() for t in tree_leaves(out["blocks"])] == before
    assert out["pos"].dtype == torch.int32


@pytest.mark.parametrize("arch", ["mamba2-780m", "mixtral-8x7b"])
def test_configs_that_cannot_chunk_are_refused(arch):
    """SSM and MoE configs: both chunk steps and both gather steps
    assert (``chunkable``), both engines raise ``ValueError``."""
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.serve import ServeEngine

    cfg = get(arch).tiny()
    assert not tsteps.chunkable(cfg, CACHE_LEN)
    assert not jsteps.chunkable(cfg, CACHE_LEN)
    with pytest.raises(AssertionError, match="chunk"):
        tsteps.make_prefill_chunk_step(cfg, CACHE_LEN)
    with pytest.raises(AssertionError, match="chunk"):
        jsteps.make_prefill_chunk_step(cfg, None, CACHE_LEN)
    with pytest.raises(AssertionError, match="chunk"):
        tsteps.make_prefix_gather_step(cfg, cache_len=CACHE_LEN,
                                       page_size=4)
    with pytest.raises(AssertionError, match="chunk"):
        jsteps.make_prefix_gather_step(cfg, cache_len=CACHE_LEN,
                                       page_size=4)
    for eng in (ServeEngine, JServeEngine):
        with pytest.raises(ValueError, match="chunked prefill"):
            eng(cfg, lambda: None, cache_len=CACHE_LEN, prefill_chunk=4,
                **({"device": "cpu"} if eng is ServeEngine else {}))


def test_ssm_block_refuses_the_chunk_mode():
    cfg = get("mamba2-780m").tiny()
    tp = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rows = tlm.init_cache(cfg, 1, CACHE_LEN, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="SSM"):
        tlm.forward(tp, cfg, torch.zeros((1, 4), dtype=torch.int32),
                    mode="prefill_chunk", pos=0, cache=rows,
                    cache_len=CACHE_LEN)


# ------------------------------------------------------------- the repair
def _qkv(s, h=2, hkv=1, dh=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, s, n, dh)).astype(np.float32)
            for n in (h, hkv, hkv)]


@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("s", [1025, 1537])
def test_qchunk_attention_short_last_chunk(s, window):
    q, k, v = map(torch.tensor, _qkv(s))
    got = tattn.qchunk_attention(q, k, v, window=window)
    want = tattn.full_attention(q, k, v, window=window)
    _close(got.numpy(), want.numpy(), ROW_TOL)


def test_qchunk_attention_matches_reference_where_it_splits():
    q, k, v = _qkv(1024)
    got = tattn.qchunk_attention(*map(torch.tensor, (q, k, v)))
    want = jattn.qchunk_attention(*map(jnp.asarray, (q, k, v)))
    _close(got.numpy(), want, ROW_TOL)


def _ssd_inputs(s, b=1, h=2, p=8, n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1
          ).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bm = rng.standard_normal((b, s, h, n), np.float32) * 0.5
    cm = rng.standard_normal((b, s, h, n), np.float32) * 0.5
    init = np.zeros((b, h, p, n), np.float32)
    return x, dt, a, bm, cm, init


@pytest.mark.parametrize("s,chunk", [(17, 8), (1025, 256)])
def test_ssd_chunked_short_last_chunk_is_chunk_invariant(s, chunk):
    args = [torch.tensor(t) for t in _ssd_inputs(s)]
    y, hf = tssm.ssd_chunked(*args[:5], chunk, args[5])
    y1, hf1 = tssm.ssd_chunked(*args[:5], s, args[5])     # one chunk
    assert y.shape == y1.shape == args[0].shape
    _close(y.numpy(), y1.numpy(), SSD_TOL)
    _close(hf.numpy(), hf1.numpy(), SSD_TOL)


def test_ssd_chunked_matches_reference_where_it_splits():
    ins = _ssd_inputs(1024)
    y, hf = tssm.ssd_chunked(*map(torch.tensor, ins[:5]), 256,
                             torch.tensor(ins[5]))
    jy, jhf = jssm.ssd_chunked(*map(jnp.asarray, ins[:5]), 256,
                               jnp.asarray(ins[5]))
    _close(y.numpy(), jy, SSD_TOL)
    _close(hf.numpy(), jhf, SSD_TOL)


@pytest.mark.parametrize("arch,s", [("minicpm3-4b", 17), ("minicpm3-4b", 1025),
                                    ("minicpm3-4b", 1537),
                                    ("mamba2-780m", 17)])
def test_prefill_at_ragged_lengths_matches_train_forward(arch, s,
                                                         monkeypatch):
    """One-shot prefill at a length that does not split into equal chunks
    (at 17 tokens the MLA prefill's query chunk is cut to 8, the tiny
    SSD chunk is 8): last logits equal the train-mode forward's — for
    the SSM, the train forward of the same weights scanned in one
    chunk."""
    cfg = get(arch).tiny()
    tp = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, s)).astype(np.int32))
    train_cfg = cfg.replace(ssm_chunk=s) if cfg.ssm_state else cfg
    want = tlm.forward(tp, train_cfg, toks, mode="train")["logits"][:, -1:]
    if s == 17 and not cfg.ssm_state:
        monkeypatch.setattr(tattn, "qchunk_attention", functools.partial(
            tattn.qchunk_attention, chunk=8))
    out = tlm.forward(tp, cfg, toks, mode="prefill", cache_len=s + 3)
    _close(out["logits"].numpy(), want.numpy(), SSD_TOL if cfg.ssm_state
           else TOL)
    assert int(out["cache"]["pos"]) == s
