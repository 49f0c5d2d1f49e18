"""The port's ServeEngine on the UMT runtime (CPU, f32, the tiny configs
of qwen2.5-14b, minicpm3-4b, mamba2-780m, mixtral-8x7b and the two
frontends, internvl2-2b with its patch embeddings and musicgen-large
with its codebook prompts): engine tokens equal the
port's one-shot tokens exactly under
seeded random arrivals and slot churn (the ``tests/test_serve_engine.py``
pattern), on UMT and on the baseline runtime; they equal the reference
``repro.serve.ServeEngine``'s tokens on the same weights; ``stats()``
carries the reference's keys (and the port's ``PORT_ONLY_STATS``); options
of later slices raise; and the CLI prints the reference's JSON line.
Every engine drains under a deadline (``repro_torch.serve.drain``): a
wedged engine fails with its stats and every thread's stack instead of
hanging the run."""
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get
from repro.models.lm import init_params as jax_init_params
from repro_torch.launch.mesh import Mesh
from repro_torch.params import params_from_numpy
from repro_torch.serve import PORT_ONLY_STATS, Request, ServeEngine, drain
from repro_torch.steps import (greedy_oneshot, make_prefill_step,
                               make_serve_step)

ROOT = Path(__file__).resolve().parents[1]
N_REQ, PLEN, GEN_MAX = 6, 8, 6
CACHE_LEN = 16
TIMEOUT_S = 120


ARCHS = ["qwen2.5-14b", "minicpm3-4b", "mamba2-780m", "mixtral-8x7b",
         "internvl2-2b", "musicgen-large"]


def frontend_inputs(cfg, n, plen, seed=1):
    """``n`` prompts of ``plen`` positions from a numpy seed: (P, K)
    codebook ids for audio; for vision ``plen - n_patches`` text tokens
    behind (n_patches, d_model) patch embeddings, so every family's
    prompt fills the same cache extent.  Returns (prompts, patches or
    None)."""
    rng = np.random.default_rng(seed)
    vision = cfg.frontend == "vision_patches"
    shp = (n, plen - (cfg.n_patches if vision else 0))
    if cfg.frontend == "audio_codebooks":
        shp = shp + (cfg.n_codebooks,)
    prompts = rng.integers(0, cfg.vocab, shp).astype(np.int32)
    patches = None
    if vision:
        patches = rng.standard_normal(
            (n, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return prompts, patches


def oneshot(cfg, params, prompts, patches, gen, cache_len):
    """The port's one-shot tokens of a prompt batch."""
    return greedy_oneshot(
        make_prefill_step(cfg, cache_len=cache_len), make_serve_step(cfg),
        params, torch.tensor(prompts),
        None if patches is None else torch.tensor(patches), gen).numpy()


@pytest.fixture(scope="module", params=ARCHS)
def built(request):
    cfg = get(request.param).tiny()
    jp = jax_init_params(cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    prompts, patches = frontend_inputs(cfg, N_REQ, PLEN)
    ref = oneshot(cfg, params, prompts, patches, GEN_MAX, CACHE_LEN)
    return dict(cfg=cfg, jp=jp, params=params, prompts=prompts,
                patches=patches, ref=ref)


def _req(b, i, cls=Request, **kw):
    """Request ``i`` of the built set, its patches included."""
    return cls(int(i), b["prompts"][i],
               patches=None if b["patches"] is None else b["patches"][i],
               **kw)


def _run(b, reqs, gaps=None, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("n_cores", 4)
    kw.setdefault("device", "cpu")
    eng = ServeEngine(b["cfg"], b["params"], **kw).start()
    for i, r in enumerate(reqs):
        eng.submit(r)
        if gaps is not None and gaps[i] > 0:
            time.sleep(gaps[i])
    return drain(eng, reqs, TIMEOUT_S), eng.pager


@pytest.mark.parametrize("seed,umt,page_size,paged_kernel", [
    (0, True, 4, True), (1, True, 8, True), (2, False, 4, True),
    (3, True, 4, False), (4, True, None, False)])
def test_engine_matches_oneshot_under_random_arrivals(built, seed, umt,
                                                      page_size,
                                                      paged_kernel):
    rng = np.random.default_rng(seed)
    order = rng.permutation(N_REQ)
    gens = rng.integers(1, GEN_MAX + 1, N_REQ)        # incl. gen == 1
    gaps = rng.exponential(0.004, N_REQ)
    reqs = [_req(built, i, max_new_tokens=int(gens[i])) for i in order]
    stats, pager = _run(built, reqs, gaps, umt=umt, page_size=page_size,
                        paged_kernel=paged_kernel)
    for r in reqs:
        got = np.asarray(r.wait(), np.int32)
        assert np.array_equal(got, built["ref"][r.rid, :r.max_new]), (
            f"request {r.rid} (seed {seed})")
    assert stats["requests"] == N_REQ == stats["prefill_reqs"]
    assert 0.0 < stats["occupancy"] <= 1.0
    if page_size is not None:   # pages in use only as the trie's cache
        assert pager.live_refs == 0
        assert pager.used_pages == pager.cached_pages


def test_tight_pool_blocks_admission_but_stays_exact(built):
    """Room for one worst-case request: admission blocks on free pages
    and every stream still equals its one-shot row."""
    reqs = [_req(built, i, max_new_tokens=GEN_MAX) for i in range(N_REQ)]
    need = -(-(PLEN + GEN_MAX - 1) // 4)
    stats, _ = _run(built, reqs, page_size=4, num_pages=need + 1,
                    paged_kernel=True)
    for r in reqs:
        assert np.array_equal(r.wait(), built["ref"][r.rid])
    assert stats["admission_blocks"] > 0 and stats["max_live_slots"] == 1


def test_eos_and_stop_give_prefixes(built):
    """A stream that meets its eos or stop ends there; the audio
    frontend emits a codebook vector a step and refuses both, with the
    reference's error, while a plain request beside them is served."""
    ref = built["ref"]
    audio = built["cfg"].frontend == "audio_codebooks"
    reqs = [_req(built, 0, max_new_tokens=GEN_MAX,
                 eos_id=1 if audio else int(ref[0, 2])),
            _req(built, 1, max_new_tokens=GEN_MAX,
                 stop=[[1]] if audio else [[int(ref[1, 1]), int(ref[1, 2])]]),
            _req(built, 2, max_new_tokens=GEN_MAX)]
    stats, _ = _run(built, reqs, paged_kernel=True, page_size=4)
    if audio:
        for r in reqs[:2]:
            with pytest.raises(ValueError, match="eos_id/stop are not "
                               "supported for audio-codebook frontends"):
                r.wait()
        assert np.array_equal(reqs[2].wait(), ref[2])
        return
    for r in reqs:
        got = list(r.wait())
        assert got == list(ref[r.rid, :len(got)])
    assert len(reqs[0].out_tokens) <= 3 and len(reqs[1].out_tokens) <= 3
    assert stats["stopped_early"] >= 1


def test_weights_task_and_response_sink(built):
    seen = []
    reqs = [_req(built, i, max_new_tokens=3) for i in range(2)]
    eng = ServeEngine(built["cfg"], lambda: built["params"], slots=2,
                      cache_len=CACHE_LEN, n_cores=4, device="cpu",
                      response_sink=seen.append, paged_kernel=True).start()
    for r in reqs:
        eng.submit(r)
    drain(eng, reqs, TIMEOUT_S)
    for r in reqs:
        assert np.array_equal(r.wait(), built["ref"][r.rid, :3])
    assert sorted(r.rid for r in seen) == [0, 1]


def test_a_shut_down_engine_is_freed_when_dropped(built):
    """An engine holds its pool and weights: once shut down and dropped
    it must be freed at once, not at the next cyclic collection (its task
    handles hold its bound methods)."""
    import gc
    import weakref

    reqs = [_req(built, i, max_new_tokens=3) for i in range(2)]
    eng = ServeEngine(built["cfg"], built["params"], slots=2,
                      cache_len=CACHE_LEN, n_cores=4, device="cpu").start()
    for r in reqs:
        eng.submit(r)
    drain(eng, reqs, TIMEOUT_S)
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None, "a dropped engine is kept alive by a cycle"
    finally:
        gc.enable()


def test_port_engine_equals_reference_engine(built):
    """Same weights, same requests: the port's engine and the reference's
    engine (paged kernel on both sides; the reference's Pallas kernel in
    interpret mode) emit the same tokens, and ``stats()`` has the
    reference's key set."""
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine

    gens = [GEN_MAX, 3, 5, 1, GEN_MAX, 2]
    jreqs = [_req(built, i, JRequest, max_new_tokens=gens[i])
             for i in range(N_REQ)]
    eng = JServeEngine(built["cfg"], built["jp"], slots=3,
                       cache_len=CACHE_LEN, n_cores=4, page_size=4,
                       paged_kernel=True).start()
    for r in jreqs:
        eng.submit(r)
    jstats = drain(eng, jreqs, TIMEOUT_S)
    treqs = [_req(built, i, max_new_tokens=gens[i]) for i in range(N_REQ)]
    tstats, _ = _run(built, treqs, page_size=4, paged_kernel=True)
    for jr, tr in zip(jreqs, treqs):
        assert np.asarray(tr.wait()).tolist() == \
            np.asarray(jr.wait()).tolist()
    assert set(tstats) - set(PORT_ONLY_STATS) == set(jstats)
    assert tstats["prefix_cache"] == jstats["prefix_cache"]


@pytest.mark.parametrize("kw", [dict(mesh=Mesh({"data": 2, "model": 1})),
                                dict(mesh=Mesh({"data": 2, "model": 2}))])
def test_options_of_later_slices_raise(built, kw):
    """A mesh with a data axis above 1: a training mesh (the sharded
    train state, ROADMAP item 18, ``tests/test_torch_fsdp.py``), which
    serving refuses as the reference's ``TP_SERVE_RULES`` map ``batch``
    to no mesh axis; tensor-parallel serving itself is ported
    (``tests/test_torch_tp.py``)."""
    with pytest.raises(NotImplementedError,
                       match="serving splits no data axis"):
        ServeEngine(built["cfg"], built["params"], device="cpu", **kw)


@pytest.mark.parametrize("arch,kw", [
    ("mamba2-780m", dict(prefill_chunk=4)),
    ("qwen2.5-14b", dict(prefix_cache="on", page_size=None))])
def test_options_the_reference_refuses_raise_its_error(arch, kw):
    """Chunked prefill on a config that cannot chunk exactly, and the
    prefix cache on a dense engine: ``ValueError`` on both engines."""
    from repro.serve import ServeEngine as JServeEngine

    cfg = get(arch).tiny()
    with pytest.raises(ValueError, match="chunk"):
        ServeEngine(cfg, lambda: None, cache_len=CACHE_LEN, device="cpu",
                    **kw)
    with pytest.raises(ValueError, match="chunk"):
        JServeEngine(cfg, lambda: None, cache_len=CACHE_LEN, **kw)


def _reference_json_keys():
    src = (ROOT / "src/repro/launch/serve.py").read_text()
    block = src[src.index('"mode": "engine"'):src.index("}))", src.index(
        '"mode": "engine"'))]
    return re.findall(r'^\s+"(\w+)":', '\n    ' + block, re.M)


@pytest.mark.parametrize("arch,extra", [
    *((a, ()) for a in ARCHS),
    ("qwen2.5-14b", ("--chunk", "3")),
    ("minicpm3-4b", ("--chunk", "5", "--prefix-cache", "on")),
    ("qwen2.5-14b", ("--policy", "ondemand", "--page-size", "2", "--pages",
                     "10"))])
def test_cli_prints_the_reference_json_line(arch, extra):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--tiny",
         "--arch", arch, "--device", "cpu", "--paged-kernel", "--batch", "2",
         "--requests", "3", "--prompt-len", "8", "--gen", "4", "--cores",
         "3", *extra],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        check=True)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert list(row) == _reference_json_keys()
    cfg = get(arch)
    assert row["paged_kernel"] is True and row["generated_shape"] == [3, 4] \
        + ([cfg.n_codebooks] if cfg.frontend == "audio_codebooks" else [])
    assert row["arch"] == f"{arch}-tiny"
    if "--chunk" in extra:              # 8-token prompts in c-token chunks
        c = int(extra[extra.index("--chunk") + 1])
        assert row["prefill_chunks"] == -(-8 // c) * row["prefill_calls"] > 0
    assert row["prefix_cache"] is (arch not in ("mamba2-780m",
                                                "mixtral-8x7b"))
    if "--policy" in extra:     # prompts of 4 full pages: every slot grows
        assert row["policy"] == "ondemand" and row["pages_grown"] > 0
        assert row["restores"] == row["evictions"]


@pytest.mark.parametrize("arch", ["internvl2-2b", "musicgen-large"])
def test_cli_frontends_engine_and_oneshot_agree(arch, capsys):
    """The serve CLI on the frontends, as the engine and one-shot: the
    reference's zero patches in front of each vision prompt (the cache
    length adds them), (P, K) codebook prompts for audio; both legs emit
    the same tokens, of shape (requests, gen[, K])."""
    from repro_torch.launch.serve import serve

    argv = ["--tiny", "--arch", arch, "--device", "cpu", "--batch", "3",
            "--requests", "3", "--prompt-len", "6", "--gen", "4",
            "--cores", "3", "--chunk", "4"]
    legs = {}
    for mode in ("engine", "oneshot"):
        legs[mode] = np.asarray(serve(argv + ["--mode", mode]))
        row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert row["mode"] == mode
    cfg = get(arch)
    k = [cfg.n_codebooks] if cfg.frontend == "audio_codebooks" else []
    assert list(legs["engine"].shape) == [3, 4] + k == row[
        "generated_shape"]
    np.testing.assert_array_equal(legs["engine"], legs["oneshot"])
