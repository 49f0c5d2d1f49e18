"""The port's launch tools (``repro_torch.launch.{analysis,op_cost,specs,
dryrun,profile_cell}``) against the reference's (``repro.launch.
{hlo_analysis,hlo_cost,specs}``), and remat "dots" against "full",
"none" and ``jax.grad`` of the reference.

Tolerances:
  * ``model_flops``, ``active_params``, ``total_params``: equal — the
    same formulas as code;
  * ``total_params`` over the elements of ``param_meta``: in [0.998, 1.0]
    — the formulas leave out the norms, biases and the SSM's small
    vectors;
  * ``op_cost`` on ``tanh(a @ b) @ c``: 1 % of the hand count, as
    ``tests/test_hlo_cost.py`` holds ``HloCost``;
  * ``op_cost`` against ``HloCost`` (mesh None) on the tiny f32 configs,
    counting the kernels' plain versions (``kernels=False``: the
    computation the reference's HLO holds): matrix-product FLOPs equal
    to the HLO's dots (the same products);
    total FLOPs within ``HLO_TOL``: elementwise ops count where each
    plain implementation runs them.  GQA and MLA measured 0.980-0.992 of
    ``HloCost`` (XLA's module runs a few more elementwise ops), so 3 %;
    the SSD family 0.876-0.976 (the two plain SSD scans do their decay
    arithmetic differently), so 15 %;
  * a kernel's site under ``OpCost``: its wrapper's ``work``, exactly;
    gradients through the sites' plain forward and backward, 1e-5 of
    those without a cost model (the same math: RMSNorm's written-out
    backward against autograd's, in f32);
  * remat "dots" against the reference's ``jax.grad`` with remat "dots":
    each leaf's gradient by its relative L2 error, 1e-4, the bound
    ``tests/test_torch_train.py`` holds the moments to, which carry the
    gradients' error (the frameworks sum in different orders).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro import steps as jsteps
from repro.configs import REGISTRY, get as jget, shapes_for
from repro.configs.base import RunShape
from repro.launch import hlo_analysis as jana
from repro.launch import specs as jspecs
from repro.launch.hlo_cost import HloCost
from repro.models import lm as jlm
from repro_torch.configs import SHAPES, get
from repro_torch.launch import analysis, dryrun, profile_cell, specs
from repro_torch.launch.op_cost import OpCost, op_cost
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.lm import _is_meta, forward, param_meta
from repro_torch.models.moe import DroplessOnMeta
from repro_torch.params import params_from_numpy
from repro_torch.steps import _token_loss, cast_tree, make_grad_step

ARCHS = sorted(REGISTRY)
TINY_SHAPES = [RunShape("p", "prefill", 64, 2), RunShape("d", "decode", 64, 2),
               RunShape("t", "train", 32, 4, accum=2)]
HLO_TOL = {"qwen2.5-14b": 0.03, "minicpm3-4b": 0.03, "mamba2-780m": 0.15}
# the reference's dryrun record (dryrun.py:87-114): the port's carries
# "device" for "mesh" and "trace_s" for "compile_s", the rest as named
REF_KEYS = {"arch", "shape", "mesh", "compile_s", "bytes_per_device",
            "total_params", "analysis_s", "roofline",
            "hbm_bytes_fused_global", "hbm_bytes_unfused_global",
            "collectives", "model_flops", "useful_flops_ratio"}
PORT_KEYS = REF_KEYS - {"mesh", "compile_s"} | {"device", "trace_s"}
# one arch of every family of the registry
FAMILIES = ["qwen2.5-14b", "minicpm3-4b", "mamba2-780m", "mixtral-8x7b",
            "jamba-v0.1-52b", "internvl2-2b", "musicgen-large"]


# ------------------------------------------------------------- analysis
@pytest.mark.parametrize("arch", ARCHS)
def test_analysis_equals_the_reference(arch):
    cfg, jcfg = get(arch), jget(arch)
    assert analysis.active_params(cfg) == jana.active_params(jcfg)
    assert analysis.total_params(cfg) == jana.total_params(jcfg)
    for shape in shapes_for(jcfg):
        assert analysis.model_flops(cfg, SHAPES[shape.name]) == \
            jana.model_flops(jcfg, shape)
    sizes = []
    tree_map(lambda m: sizes.append(int(np.prod(m.shape))), param_meta(cfg),
             is_leaf=_is_meta)
    n = sum(sizes)
    assert 0.998 <= analysis.total_params(cfg) / n <= 1.0


def test_roofline_is_one_h100():
    rl = analysis.Roofline(flops=989e12, hbm_bytes=2 * 3.35e12)
    assert rl.t_compute == pytest.approx(1.0)
    assert rl.t_memory == pytest.approx(2.0)
    assert rl.t_bound == pytest.approx(2.0) and rl.bottleneck == "memory"
    rec = rl.as_dict()
    assert rec["chips"] == 1 and rec["t_collective_s"] == 0.0 \
        and rec["coll_bytes_per_chip"] == 0


# -------------------------------------------------------------- op_cost
def test_op_cost_matches_hand_math():
    """``tests/test_hlo_cost.py:15-27`` on the port: FLOPs within 1 %;
    bytes, counted exactly: each product's operands and result, the tanh's
    operand and result; the arguments and the new result once."""
    a, b, c = (torch.empty(s, device="meta") for s in
               ((128, 256), (256, 512), (512, 64)))
    out, cost = op_cost(lambda a, b, c: torch.tanh(a @ b) @ c, a, b, c)
    want = 2 * 128 * 256 * 512 + 128 * 512 + 2 * 128 * 512 * 64
    assert abs(cost.flops - want) / want < 0.01
    assert cost.flops_matmul == 2 * 128 * 256 * 512 + 2 * 128 * 512 * 64
    mm1 = 4 * (128 * 256 + 256 * 512 + 128 * 512)
    tanh = 4 * 2 * 128 * 512
    mm2 = 4 * (128 * 512 + 512 * 64 + 128 * 64)
    assert cost.bytes == mm1 + tanh + mm2
    assert cost.bytes_fused == mm1 + mm2         # the tanh fuses away
    assert cost.argument == 4 * (128 * 256 + 256 * 512 + 512 * 64)
    assert cost.output == 4 * 128 * 64
    assert cost.bytes_min == cost.argument + cost.output
    # a @ b and its tanh are alive together, nothing larger
    assert cost.peak_temp == 2 * 4 * 128 * 512


def test_op_cost_charges_in_place_writes_at_the_update():
    """A cache write (``index_put_``/``copy_`` of one row) is charged at
    its update, in ``bytes`` and in ``bytes_min``, not at the cache's
    size."""
    cache = torch.empty(64, 1024, device="meta")
    row = torch.empty(1, 1024, device="meta")

    def step(cache, row):
        cache[5:6] = row * 2.0
        return cache

    _, cost = op_cost(step, cache, row)
    assert cost.bytes_min == cache.nbytes + row.nbytes + row.nbytes
    assert cost.bytes < 10 * row.nbytes


def _prefill_matmuls(n_layers, kernels):
    cfg = get("qwen2.5-14b").tiny(n_layers=n_layers)
    shape = RunShape("p", "prefill", 40, 2)
    _, cost = op_cost(dryrun.cell_step(cfg, shape),
                      **specs.input_specs(cfg, shape), kernels=kernels)
    return cost, cfg


@pytest.mark.parametrize("kernels", [False, True])
def test_op_cost_counts_every_layer(kernels):
    """Python loops run every layer: n layers count n times one layer's
    products, plus the LM head at the last position (the embedding is a
    gather, no product).  One layer by hand: Q, K, V, O and the gated
    MLP over 2 x 40 tokens, and attention's two products over each of
    the 4 heads: over every (query, key) pair in the plain version
    (``kernels=False``), over the 40 * 41 / 2 causal pairs at the flash
    kernel's site, where the products are the kernel's."""
    runs = [_prefill_matmuls(n, kernels) for n in (2, 3, 5)]
    (c2, cfg), (c3, _), (c5, _) = runs
    t, d, h, hkv, dh, ff = 80, cfg.d_model, 4, cfg.n_kv_heads, 16, \
        cfg.d_ff
    proj = 2 * t * (d * h * dh + 2 * d * hkv * dh + h * dh * d + 3 * d * ff)
    square = 2 * 2 * (2 * 40 * 40 * h * dh)
    causal = 2 * 4 * h * (40 * 41 // 2) * dh
    layer = proj + (0 if kernels else square)
    head = 2 * 2 * d * cfg.vocab
    f2, f3, f5 = (c.flops_matmul for c, _ in runs)
    assert f3 - f2 == layer and f5 - f3 == 2 * layer
    assert f2 == 2 * layer + head
    sites = [c.flops_kernels - c.kernels.get("rms_norm", [0, 0])[1]
             for c, _ in runs]
    assert sites == ([0, 0, 0] if kernels is False else
                     [2 * causal, 3 * causal, 5 * causal])


# ------------------------------------------------------ kernels' sites
@pytest.mark.parametrize("sq,sk,causal,window", [
    (64, 64, True, None), (64, 64, True, 16), (48, 64, False, None)])
def test_flash_site_is_charged_as_the_kernel(sq, sk, causal, window):
    """Flash attention on meta under ``OpCost``: the kernel's two
    products over the pairs the mask leaves, q, k and v read and the
    output written once, and its output the only allocation; counting the
    plain version (``kernels=False``) scores every pair and holds f32
    scores."""
    from repro_torch.kernels import flash_attention

    b, h, hkv, d = 2, 4, 2, 16
    q = torch.empty(b, sq, h, d, device="meta")
    k, v = (torch.empty(b, sk, hkv, d, device="meta") for _ in range(2))

    def fn(q, k, v):
        return flash_attention(q, k, v, causal=causal, window=window)
    _, kern = op_cost(fn, q, k, v)
    _, plain = op_cost(fn, q, k, v, kernels=False)
    i, j = np.arange(sq)[:, None], np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    flops = 4 * b * h * int(mask.sum()) * d
    assert kern.kernels == {"flash_attention": [
        1, flops, 4 * (2 * b * sq * h * d + 2 * b * sk * hkv * d)]}
    assert kern.flops == kern.flops_kernels == flops
    assert kern.flops_matmul == 0
    assert plain.flops_matmul == 4 * b * h * sq * sk * d
    assert kern.peak_temp == 4 * b * sq * h * d
    assert plain.peak_temp >= 4 * b * h * sq * sk + kern.peak_temp


def test_paged_site_counts_the_live_positions():
    """A paged decode's site reads each slot's pos + 1 cached positions on
    the CPU; on meta, which holds no positions, the table's capacity."""
    from repro_torch.kernels import paged_decode_attention

    b, h, hkv, dh, ps, pages = 2, 4, 2, 16, 8, 4
    for dev, live in (("cpu", 5 + 20), ("meta", 2 * pages * ps)):
        q = torch.zeros(b, 1, h, dh, device=dev)
        pool = torch.zeros(1 + b * pages, ps, hkv, dh, device=dev)
        table = torch.arange(1, 1 + b * pages, dtype=torch.int32,
                             device=dev).reshape(b, pages)
        pos = torch.tensor([4, 19], dtype=torch.int32, device=dev)
        _, cost = op_cost(lambda *a: paged_decode_attention(
            *a, page_size=ps), q, pool, pool, table, pos)
        assert cost.kernels["paged_decode_attention"][1] == \
            4 * live * h * dh, dev


def test_sites_charge_the_backward_kernels():
    """A tiny mamba2 grad step on the CPU under ``OpCost``: every RMSNorm
    (two a layer and the final one) and SSD scan is a kernel's site in
    the forward and in the backward, as on the card, and the gradients
    through the sites' plain forward and backward are autograd's (1e-5
    of each leaf)."""
    from repro.data import batch_for_step
    from repro_torch.models.lm import init_params

    cfg = get("mamba2-780m").tiny(remat="none")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         dtype=cfg.param_dtype)
    batch = batch_for_step(0, seed=3, batch=2, seq=16, vocab=cfg.vocab,
                           accum=1)
    want, _ = make_grad_step(cfg)(params, batch)
    with OpCost() as oc:
        got, _ = make_grad_step(cfg)(params, batch)
    n = cfg.n_layers
    assert {k: v[0] for k, v in oc.cost.kernels.items()} == {
        "rms_norm": 2 * n + 1, "rms_norm_bwd": 2 * n + 1, "ssd_scan": n,
        "ssd_scan_bwd": n}
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        den = w.norm().item() or 1.0
        assert (g - w).norm().item() / den <= 1e-5


def _hlo_dot_flops(hc):
    """The FLOPs of ``HloCost``'s dots alone, through its while loops'
    trip counts (the same walk as ``HloCost.comp_cost``)."""
    from repro.launch import hlo_cost as hmod

    def walk(name, mult):
        comp = hc.comps.get(name)
        total = 0.0
        for ins in comp.instrs if comp else ():
            if ins.op == "dot":
                total += mult * hmod._dot_flops(ins, comp)
            if ins.op == "while":
                trips = re.search(r'"known_trip_count":\{"n":"(\d+)"',
                                  ins.line)
                body = re.search(r"body=(%?[\w.\-]+)", ins.line).group(1)
                total += walk(body, mult * float(trips.group(1)))
            elif ins.calls:
                total += sum(walk(c, mult) for c in ins.calls)
        return total
    return walk(hc.entry, 1.0)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "minicpm3-4b",
                                  "mamba2-780m"])
def test_op_cost_against_hlo_cost(arch):
    cfg, jcfg = get(arch).tiny(), jget(arch).tiny()
    for shape in TINY_SHAPES:
        jspec, _ = jspecs.input_specs(jcfg, shape, None)
        if shape.kind == "prefill":
            fn = jsteps.make_prefill_step(jcfg, None)
            args = (jspec["params"], jspec["tokens"])
        elif shape.kind == "decode":
            fn = jsteps.make_serve_step(jcfg, None)
            args = (jspec["params"], jspec["cache"], jspec["tokens"])
        else:
            fn = jsteps.make_train_step(jcfg, None)
            args = (jspec["state"], jspec["batch"])
        hc = HloCost(jax.jit(fn).lower(*args).compile().as_text())
        _, cost = op_cost(dryrun.cell_step(cfg, shape),
                          **specs.input_specs(cfg, shape), kernels=False)
        assert cost.flops_matmul == pytest.approx(_hlo_dot_flops(hc),
                                                  rel=1e-12), shape
        want = hc.cost().flops
        assert abs(cost.flops / want - 1) <= HLO_TOL[arch], (
            shape, cost.flops, want)


# ---------------------------------------------------------------- specs
def _shapes(tree):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in tree]


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch):
    cfg, jcfg = get(arch), jget(arch)
    for shape in shapes_for(jcfg):
        want, _ = jspecs.input_specs(jcfg, shape, None)
        got = specs.input_specs(cfg, SHAPES[shape.name])
        assert sorted(got) == sorted(want)
        for k in want:
            assert _shapes(tree_leaves(got[k])) == _shapes(
                jax.tree.leaves(want[k])), (shape.name, k)
            assert all(t.device.type == "meta" for t in tree_leaves(got[k]))


# --------------------------------------------------------------- dryrun
class _Devices(TorchDispatchMode):
    """The devices of every tensor an op makes, and the largest made off
    meta."""

    def __init__(self):
        super().__init__()
        self.seen, self.off_meta = set(), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.seen.add(t.device.type)
                if t.device.type != "meta":
                    self.off_meta = max(self.off_meta, t.nbytes)
        return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_dryrun_cell_of_every_family(arch):
    """A full-size decode cell of each family on meta: nothing allocated
    on a device (every op's tensors on meta but the rope's frequency
    table, 64 floats made on the host from numpy as on the card's path),
    the reference's record keys, its ``model_flops`` and
    ``total_params``."""
    with _Devices() as dev:
        rec = dryrun.run_cell(arch, "decode_32k", verbose=False)
    assert dev.seen <= {"meta", "cpu"} and dev.off_meta <= 1024
    assert set(rec) == PORT_KEYS
    assert rec["device"] == "H100, one card"
    assert rec["model_flops"] == jana.model_flops(
        jget(arch), jspecs_shape("decode_32k"))
    assert rec["total_params"] == jana.total_params(jget(arch))
    assert rec["roofline"]["flops_global"] > 0
    assert rec["bytes_per_device"]["peak"] == \
        rec["bytes_per_device"]["argument"] + rec["bytes_per_device"]["temp"]


def jspecs_shape(name):
    from repro.configs import SHAPES as JSHAPES
    return JSHAPES[name]


def _cut(monkeypatch, cfg, shape):
    """``dryrun.run_cell`` on ``cfg`` and ``shape`` in place of the
    registry's."""
    monkeypatch.setattr(dryrun, "get", lambda arch: cfg)
    monkeypatch.setattr(dryrun, "SHAPES", {shape.name: shape})


def test_dryrun_train_cell_on_a_cut_config(monkeypatch):
    """A train cell runs the whole step (forward, remat, backward, AdamW)
    on meta: remat "full" counts more FLOPs than "none" (its recomputed
    forward), and AdamW writes every parameter and moment in place, so
    ``bytes_min`` holds the state once read and once written."""
    shape = dataclasses.replace(SHAPES["train_4k"], batch=2, seq=256,
                                accum=2)
    recs = {}
    for r in ("none", "full"):
        _cut(monkeypatch, get("qwen2.5-14b").replace(n_layers=2, remat=r),
             shape)
        recs[r] = dryrun.run_cell("qwen2.5-14b", "train_4k", verbose=False)
    flops = {r: rec["roofline"]["flops_global"] for r, rec in recs.items()}
    assert flops["none"] < flops["full"]
    mem = recs["full"]["bytes_per_device"]
    state = 3 * 4 * analysis.total_params(get("qwen2.5-14b").replace(
        n_layers=2))
    assert mem["argument"] == pytest.approx(state, rel=1e-3)
    assert recs["full"]["roofline"]["hbm_bytes_global"] == pytest.approx(
        2 * mem["argument"], rel=1e-3)


def test_dryrun_skips_long_500k_for_full_attention():
    rec = dryrun.run_cell("qwen2.5-14b", "long_500k", verbose=False)
    assert "skipped" in rec


def test_dryrun_out_resumes(tmp_path, capsys):
    out = tmp_path / "cells.jsonl"
    argv = ["--arch", "mamba2-780m", "--shape", "long_500k", "--out",
            str(out)]
    dryrun.main(argv)
    assert len(out.read_text().splitlines()) == 1
    dryrun.main(argv)
    assert "skip cached mamba2-780m long_500k" in capsys.readouterr().out
    assert len(out.read_text().splitlines()) == 1
    dryrun.main(argv + ["--no-probe"])          # still cached


def test_dryrun_ragged_moe_raises_its_named_error(monkeypatch, capsys):
    with monkeypatch.context() as m:
        _cut(m, get("mixtral-8x7b").tiny(moe_impl="ragged"),
             RunShape("d", "decode", 64, 2))
        with pytest.raises(DroplessOnMeta, match="onehot"):
            dryrun.run_cell("mixtral-8x7b", "d", verbose=False)
    monkeypatch.setattr(dryrun, "get",
                        lambda a: get(a).replace(moe_impl="ragged"))
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "mixtral-8x7b", "--shape", "decode_32k"])
    assert e.value.code == 1
    assert "ERROR: mixtral-8x7b decode_32k DroplessOnMeta" in \
        capsys.readouterr().out


def test_profile_cell_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_cell.profile("qwen2.5-14b", "decode_32k", layers=2)
    cfg, shape, cuts = profile_cell.cut_cell(
        "mamba2-780m", "train_4k", batch=4, seq=1024, accum=1)
    assert (shape.batch, shape.seq, shape.accum) == (4, 1024, 1)
    assert cfg == get("mamba2-780m")
    assert cuts == ["batch 256 -> 4", "seq 4096 -> 1024", "accum 8 -> 1"]
    with pytest.raises(ValueError, match="microbatches"):
        profile_cell.cut_cell("mamba2-780m", "train_4k", batch=4)


# ---------------------------------------------------------- remat "dots"
def _jgrads(jcfg, jparams, batch):
    def loss_fn(p):
        out = jlm.forward(jsteps.cast_tree(p, jcfg.dtype), jcfg,
                          batch["tokens"][0], mode="train")
        loss = jsteps._token_loss(out, batch["labels"][0], jcfg)
        return loss + 0.01 * out["aux"] / max(jcfg.n_layers, 1)
    return jax.jit(jax.grad(loss_fn))(jparams)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mixtral-8x7b",
                                  "mamba2-780m"])
def test_remat_dots_matches_jax_grad(arch):
    from repro.data import batch_for_step

    jcfg = jget(arch).tiny(remat="dots")
    cfg = get(arch).tiny(remat="dots")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               "cpu")
    batch = batch_for_step(0, seed=3, batch=2, seq=16, vocab=cfg.vocab,
                           accum=1)
    want = jax.tree.leaves(_jgrads(jcfg, jparams, batch))
    got, _ = make_grad_step(cfg)(params, batch)
    for g, w in zip(tree_leaves(got), want):
        w = np.asarray(w, np.float32)
        den = np.linalg.norm(w) or 1.0
        assert np.linalg.norm(g.numpy() - w) / den <= 1e-4


def _backward_matmuls(cfg, params, batch):
    """Matrix-product FLOPs of the forward and of the backward, apart."""
    live = [p.requires_grad_() for p in tree_leaves(params)]
    assert live
    with OpCost() as fwd:
        out = forward(cast_tree(params, cfg.dtype), cfg, batch["tokens"][0],
                      mode="train")
        loss = _token_loss(out, batch["labels"][0], cfg)
    with OpCost() as bwd:
        loss.backward()
    return fwd.cost.flops_matmul, bwd.cost.flops_matmul


def test_remat_dots_recomputes_no_product():
    """Under "full" the backward recomputes the products of the
    checkpointed repeats; under "dots" none: its backward runs exactly
    the products of the backward without remat."""
    cfg = get("qwen2.5-14b").tiny()
    shape = RunShape("t", "train", 16, 2)
    params = {k: v for k, v in specs.input_specs(
        cfg, shape)["state"]["params"].items()}
    tok = torch.zeros((1, 2, 16), dtype=torch.int32, device="meta")
    batch = {"tokens": tok, "labels": tok}
    res = {r: _backward_matmuls(cfg.replace(remat=r), params, batch)
           for r in ("none", "full", "dots")}
    assert res["dots"][0] == res["none"][0] == res["full"][0]
    assert res["dots"][1] == res["none"][1] < res["full"][1]
