"""The port's logical-axis sharding rules (``repro_torch.sharding``) and
its tensor-parallel layout, on the CPU with no process group:

  * every ``REGISTRY`` config's parameter meta (shapes and logical axes)
    equals the reference's, leaf for leaf, and so do its serve-cache
    leaves;
  * for every such leaf, at model sizes 1, 2, 4, 8 and 16, strict and
    padded, under ``LOGICAL_RULES`` and ``TP_SERVE_RULES``, the port's
    ``logical_spec`` equals ``repro.sharding.rules.logical_spec`` (which
    reads only ``mesh.shape``, so both get a stand-in mesh);
  * the property cases of ``tests/test_sharding_rules.py`` as seeded
    sweeps (strict specs divide, padded specs waste at most 2x, no mesh
    axis twice) and its worked examples;
  * ``params.shard_params`` followed by concatenation gives back the
    full tree exactly, the SSD mixer's leaves by the port's own layout
    (``models.ssm.TP_LOCAL``), and ``steps.local_cache_meta`` gives the
    per-rank cache shapes: K/V and the SSM state at 1/n, the conv tail at
    ``(d_inner/n + 2 N G) / conv_dim``, MLA latents whole."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY
from repro.configs import get as jget
from repro.models import lm as jlm
from repro.sharding import rules as jrules
from repro.steps import TP_SERVE_RULES as J_TP_SERVE_RULES
from repro_torch.configs import get
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm as tlm
from repro_torch.models.ssm import TP_LOCAL, conv_dim
from repro_torch.params import shard_params
from repro_torch.sharding import LOGICAL_RULES, logical_spec
from repro_torch.steps import (DECODE_RULES, SERVE_CACHE_AXES,
                               TP_SERVE_RULES, local_cache_meta,
                               serve_cache_axes)

SIZES = (1, 2, 4, 8, 16)
ARCHS = sorted(REGISTRY)


class StandIn:
    """What ``logical_spec`` reads of a mesh: its axis sizes."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


def _ref_spec(shape, axes, n, rules, strict):
    spec = tuple(jrules.logical_spec(shape, axes, StandIn(1, n), rules,
                                     strict=strict))
    return spec + (None,) * (len(shape) - len(spec))


def _port_leaves(meta, path=""):
    if isinstance(meta, tlm.LeafMeta):
        return [(path, meta)]
    if isinstance(meta, dict):
        return [x for k in sorted(meta) for x in _port_leaves(meta[k],
                                                             f"{path}/{k}")]
    return [x for i, m in enumerate(meta)
            for x in _port_leaves(m, f"{path}[{i}]")]


def _ref_leaves(meta):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        meta, is_leaf=lambda x: isinstance(x, jlm.LeafMeta))
    out = []
    for path, m in flat:
        p = "".join(f"/{k.key}" if hasattr(k, "key") else f"[{k.idx}]"
                    for k in path)
        out.append((p, m))
    return sorted(out, key=lambda x: x[0])


def _both(arch):
    """(path, port LeafMeta, reference LeafMeta, is a parameter) of every
    parameter and serve-cache leaf of ``arch``."""
    tcfg, jcfg = get(arch), jget(arch)
    pairs = []
    for tm, jm, par in ((tlm.param_meta(tcfg), jlm.param_meta(jcfg), True),
                        (tlm.cache_meta(tcfg, 4, 64),
                         jlm.cache_meta(jcfg, 4, 64), False)):
        t, j = sorted(_port_leaves(tm)), _ref_leaves(jm)
        assert [p for p, _ in t] == [p for p, _ in j]
        pairs += [(p, a, b, par) for (p, a), (_, b) in zip(t, j)]
    return pairs


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_shapes_and_axes_equal_the_reference(arch):
    """(A cache leaf's init kind is moot: both packages zero caches.)"""
    for path, t, j, par in _both(arch):
        assert tuple(t.shape) == tuple(j.shape), path
        assert tuple(t.axes) == tuple(j.axes), path
        assert not par or t.init == j.init, path
    assert tlm.param_logical_axes(get(arch))["blocks"][0] is not None


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_spec_equals_the_reference_on_every_leaf(arch):
    n_checked = 0
    for path, t, _, _ in _both(arch):
        shape = tuple(t.shape)
        for n in SIZES:
            for rules, jr in ((None, None),
                              (TP_SERVE_RULES, J_TP_SERVE_RULES)):
                for strict in (True, False):
                    got = logical_spec(shape, t.axes, StandIn(1, n), rules,
                                       strict=strict)
                    assert got == _ref_spec(shape, t.axes, n, jr, strict), (
                        path, n, rules, strict)
                    n_checked += 1
        name = path.rsplit("/", 1)[-1]
        if name in SERVE_CACHE_AXES:      # the engine's name table too
            for n in SIZES:
                axes = serve_cache_axes(name, len(shape))
                assert logical_spec(shape, axes, StandIn(1, n),
                                    TP_SERVE_RULES, strict=True) == \
                    _ref_spec(shape, axes, n, J_TP_SERVE_RULES, True)
    assert n_checked > 100


def test_rule_tables_equal_the_reference():
    import repro.steps as jsteps

    assert LOGICAL_RULES == jrules.LOGICAL_RULES
    assert TP_SERVE_RULES == jsteps.TP_SERVE_RULES
    assert DECODE_RULES == jsteps.DECODE_RULES
    assert SERVE_CACHE_AXES == jsteps.SERVE_CACHE_AXES
    for name, nd in (("k", 5), ("pos", 1), ("mystery", 3), ("conv", 4)):
        assert serve_cache_axes(name, nd) == jsteps.serve_cache_axes(name,
                                                                     nd)


# ------------------------------------------------- property sweeps (seeded)
AXES = list(LOGICAL_RULES) + [None]


def _cases(seed, n=300):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        k = int(rng.integers(1, 5))
        shape = tuple(int(x) for x in rng.integers(1, 4097, k))
        axes = tuple(AXES[int(i)] for i in rng.integers(0, len(AXES), k))
        yield shape, axes


def _split(part, mesh):
    n = 1
    for a in (part if isinstance(part, tuple) else (part,)):
        n *= mesh.shape[a]
    return n


@pytest.mark.parametrize("data,model", [(4, 2), (1, 8), (16, 16)])
def test_strict_specs_always_divide(data, model):
    mesh = StandIn(data, model)
    for shape, axes in _cases(0):
        spec = logical_spec(shape, axes, mesh, strict=True)
        assert spec == _ref_spec_mesh(shape, axes, mesh, True)
        for dim, part in zip(shape, spec):
            if part is not None:
                assert dim % _split(part, mesh) == 0, (dim, part)


@pytest.mark.parametrize("data,model", [(4, 2), (1, 8), (16, 16)])
def test_padded_specs_waste_at_most_2x(data, model):
    mesh = StandIn(data, model)
    for shape, axes in _cases(1):
        spec = logical_spec(shape, axes, mesh, strict=False)
        assert spec == _ref_spec_mesh(shape, axes, mesh, False)
        for dim, part in zip(shape, spec):
            if part is not None:
                n = _split(part, mesh)
                assert -(-dim // n) * n < 2 * dim, (dim, n)


@pytest.mark.parametrize("data,model", [(4, 2), (1, 8), (16, 16)])
def test_no_mesh_axis_used_twice(data, model):
    mesh = StandIn(data, model)
    for shape, axes in _cases(2):
        for strict in (True, False):
            used = []
            for part in logical_spec(shape, axes, mesh, strict=strict):
                if part is not None:
                    used += list(part if isinstance(part, tuple)
                                 else (part,))
            assert len(set(used)) == len(used)


def _ref_spec_mesh(shape, axes, mesh, strict):
    spec = tuple(jrules.logical_spec(shape, axes, mesh, strict=strict))
    return spec + (None,) * (len(shape) - len(spec))


def test_worked_examples_of_the_reference():
    """The reference's named cases (``tests/test_sharding_rules.py``) on
    the port's resolver."""
    big = StandIn(16, 16)
    spec = logical_spec((50280, 1536), ("vocab", "fsdp"), big, strict=True)
    assert spec == (None, "data")
    assert logical_spec((2, 4096, 40, 128), ("batch", "seq", "heads", None),
                        big)[2] == "model"          # 40 padded to 48
    assert logical_spec((2, 4096, 40, 128), ("batch", "seq", "heads", None),
                        big, strict=True)[2] is None
    m8 = StandIn(1, 8)
    assert logical_spec((8, 8), ("seq_shard", "kv_heads"), m8, DECODE_RULES,
                        strict=True) == ("model", None)
    assert logical_spec((8, 8), ("seq_shard", "kv_heads"), m8,
                        TP_SERVE_RULES, strict=True) == (None, "model")
    assert logical_spec((2, 9, 8, 8, 64), serve_cache_axes("k", 5), m8,
                        TP_SERVE_RULES, strict=True) == (
        None, None, None, "model", None)
    for strict in (True, False):        # 2 KV heads on 8: replicate
        assert logical_spec((2, 9, 8, 2, 64), serve_cache_axes("k", 5), m8,
                            TP_SERVE_RULES, strict=strict)[3] is None
    assert logical_spec((2, 9, 8, 8, 64), serve_cache_axes("k", 5), m8,
                        DECODE_RULES)[2:4] == ("model", None)
    for name, shape in (("ckv", (2, 9, 8, 160)), ("krope", (2, 9, 8, 32))):
        assert logical_spec(shape, serve_cache_axes(name, 4), m8,
                            TP_SERVE_RULES, strict=True) == (None,) * 4
    assert logical_spec((2, 4, 8, 64, 16), serve_cache_axes("state", 5),
                        m8, TP_SERVE_RULES, strict=True)[2] == "model"
    assert logical_spec((2, 4, 3, 256), serve_cache_axes("conv", 4), m8,
                        TP_SERVE_RULES, strict=True)[3] == "model"
    assert logical_spec((2, 4, 2, 64, 16), serve_cache_axes("state", 5),
                        m8, TP_SERVE_RULES, strict=True)[2] is None
    assert logical_spec((8, 64, 512), ("heads_w", None, "fsdp"), m8,
                        TP_SERVE_RULES, strict=True)[:2] == ("model", None)


# ---------------------------------------------------- the port's TP layout
TP_ARCHS = ["qwen2.5-14b", "minicpm3-4b", "mamba2-780m", "internvl2-2b",
            "musicgen-large"]


def _unshard(parts, full_meta, path, cfg, n, ssm):
    """The full leaf from its n shards, by the layout that cut it."""
    name = path.rsplit("/", 1)[-1]
    if ssm and name in TP_LOCAL:
        kind = TP_LOCAL[name]
        if kind != "conv":
            return torch.cat(parts, dim=-1)
        di = cfg.d_inner
        tail = [p[..., di // n:] for p in parts]
        for t in tail[1:]:                  # B and C whole on every rank
            assert torch.equal(t, tail[0]), path
        return torch.cat([p[..., :di // n] for p in parts] + [tail[0]],
                         dim=-1)
    split = [d for d, (a, b) in enumerate(zip(full_meta.shape,
                                              parts[0].shape)) if a != b]
    assert len(split) <= 1, path
    if not split:
        for p in parts[1:]:
            assert torch.equal(p, parts[0]), path
        return parts[0]
    return torch.cat(parts, dim=split[0])


def _flat(tree, path=""):
    if isinstance(tree, tlm.LeafMeta):
        return {path: tree}
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, tuple):
        return {k2: v2 for i, t in enumerate(tree)
                for k2, v2 in _flat(t, f"{path}[{i}]").items()}
    return {path: tree}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_shard_params_then_concatenation_gives_the_tree_back(arch, n):
    cfg = get(arch).tiny()
    full = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shards = [shard_params(full, cfg, Mesh({"data": 1, "model": n}, r))
              for r in range(n)]
    meta = dict(_port_leaves(tlm.param_meta(cfg)))
    flat_full = _flat(full)
    flat_parts = [_flat(s) for s in shards]
    ssm_blocks = {f"/blocks[{i}]/mixer" for i, sp in enumerate(cfg.pattern)
                  if sp.kind == "ssm"}
    n_split = 0
    for path, leaf in flat_full.items():
        parts = [f[path] for f in flat_parts]
        ssm = path.rsplit("/", 1)[0] in ssm_blocks
        back = _unshard(parts, meta[path], path, cfg, n, ssm)
        assert back.dtype == leaf.dtype and torch.equal(back, leaf), path
        n_split += parts[0].shape != leaf.shape
        for p in parts:                     # a copy, not a view of full
            assert p.untyped_storage().data_ptr() != \
                leaf.untyped_storage().data_ptr(), path
    assert n_split >= 4


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "minicpm3-4b",
                                  "mamba2-780m"])
def test_local_cache_shapes(arch, n):
    cfg = get(arch).tiny()
    mesh = Mesh({"data": 1, "model": n})
    full = _flat(tlm.cache_meta(cfg, 3, 16))
    loc = _flat(local_cache_meta(cfg, 3, 16, mesh))
    for path, m in full.items():
        name, got = path.rsplit("/", 1)[-1], loc[path].shape
        numel, lnumel = int(np.prod(m.shape)), int(np.prod(got))
        if name in ("k", "v", "state"):
            assert lnumel * n == numel, path
        elif name == "conv":
            cd = conv_dim(cfg)
            assert lnumel * cd == numel * (cfg.d_inner // n + cd
                                           - cfg.d_inner), path
        else:                               # latents, pos: whole
            assert got == m.shape, path
