"""The port's checkpointing (``repro_torch.checkpoint``): the reference's
bars (``tests/test_substrates.py``) repeated on the port, the on-disk
format shared with the reference in both directions (f32, bf16 and int32
leaves, and whole train states), and the snapshot taken at ``save``: the
port's train step updates the state in place, so a save followed by an
update must still load the state as it was.  Loads are exact (bytes)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get
from repro.optim import OptHParams as JHP
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.core import UMTRuntime
from repro_torch.data import batch_for_step
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import OptHParams
from repro_torch.params import train_state_from_numpy
from repro_torch.steps import make_train_step


def _tiny_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 8), generator=g),
                       "b": torch.zeros((8,)),
                       "h": torch.randn((4, 3), generator=g).bfloat16()},
            "blocks": ({"k": torch.randn(3, generator=g)},
                       {"k": torch.randn(3, generator=g)}),
            "step": torch.tensor(5, dtype=torch.int32)}


def _same(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    state = _tiny_state()
    save_checkpoint(state, 5, str(tmp_path))
    loaded, step = load_checkpoint(str(tmp_path), state)
    assert step == 5
    _same(loaded, state)
    assert isinstance(loaded["blocks"], tuple)


@pytest.mark.parametrize("read_bytes", [1, 300, 8 << 30])
def test_restore_reads_ahead_within_its_byte_bound(read_bytes, tmp_path,
                                                   monkeypatch):
    """The restore's read-ahead (threads, at most ``READ_BYTES`` held, or
    one larger leaf) gives back every leaf in order: one leaf at a time,
    a few at a time, all at once."""
    from repro_torch.checkpoint import manager

    monkeypatch.setattr(manager, "READ_BYTES", read_bytes)
    state = _tiny_state()
    save_checkpoint(state, 5, str(tmp_path))
    loaded, step = load_checkpoint(str(tmp_path), state)
    assert step == 5
    _same(loaded, state)


def test_checkpoint_async_via_umt(tmp_path):
    state = _tiny_state()
    with UMTRuntime(n_cores=2) as rt:
        w = save_checkpoint(state, 7, str(tmp_path), rt=rt, wait=False)
        w()
    loaded, step = load_checkpoint(str(tmp_path), state)
    assert step == 7
    _same(loaded, state)


def test_checkpoint_detects_corruption(tmp_path):
    state = _tiny_state()
    save_checkpoint(state, 1, str(tmp_path))
    leaf = tmp_path / "step_000001" / "leaf_00000.npy"
    data = bytearray(leaf.read_bytes())
    data[0] ^= 0xFF
    leaf.write_bytes(bytes(data))
    with pytest.raises(IOError, match="checksum"):
        load_checkpoint(str(tmp_path), state)


def test_checkpoint_ignores_uncommitted_and_keeps_n(tmp_path):
    state = _tiny_state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(state, s, wait=True)
    assert mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["step_000003", "step_000004"]
    os.makedirs(tmp_path / "step_000009.tmp")
    _, step = load_checkpoint(str(tmp_path), state)
    assert step == 4


def test_checkpoint_crash_mid_save_leaves_previous_intact(tmp_path):
    state = _tiny_state()
    save_checkpoint(state, 1, str(tmp_path))
    os.makedirs(tmp_path / "step_000002.tmp")
    (tmp_path / "step_000002.tmp" / "leaf_00000.npy").write_bytes(b"junk")
    _, step = load_checkpoint(str(tmp_path), state)
    assert step == 1


def test_save_then_in_place_update_loads_the_saved_state(tmp_path):
    """The port updates the train state in place: ``save`` snapshots
    every leaf before it returns, so the update after it (here while the
    UMT writes are still queued) does not reach the files."""
    cfg = get("qwen2.5-14b").tiny()
    jstate = jsteps.init_train_state(cfg, jax.random.PRNGKey(0), JHP())
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   "cpu")
    before = tree_map(torch.clone, state)
    step_fn = make_train_step(cfg, OptHParams(lr=1e-2, warmup=1))
    with UMTRuntime(n_cores=2) as rt:
        mgr = CheckpointManager(str(tmp_path), rt=rt)
        mgr.save(state, 0, wait=False)
        state, _ = step_fn(state, batch_for_step(0, seed=1, batch=2, seq=8,
                                                 vocab=cfg.vocab))
        mgr.wait()
    assert int(state["step"]) == 1
    loaded, _ = mgr.restore(before)
    _same(loaded, before)
    assert not torch.equal(tree_leaves(state["params"])[0],
                           tree_leaves(before["params"])[0])


def test_restore_places_leaves_on_device_from_a_meta_template(tmp_path):
    state = _tiny_state()
    save_checkpoint(state, 3, str(tmp_path))
    template = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), state)
    loaded, step = load_checkpoint(str(tmp_path), template, device="cpu")
    _same(loaded, state)
    bad = dict(template, step=torch.empty((2,), device="meta"))
    with pytest.raises(ValueError, match="template"):
        load_checkpoint(str(tmp_path), bad, device="cpu")


def _jtree(state):
    """The tiny state as the reference holds it (bf16 via ml_dtypes)."""
    return jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else
            jnp.int32 if t.dtype == torch.int32 else jnp.float32),
        state)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    state = _tiny_state()
    save_checkpoint(state, 2, str(tmp_path))
    jt = _jtree(state)
    loaded, step = jload(str(tmp_path), jt)
    assert step == 2
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(jt)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    state = _tiny_state()
    jsave(_jtree(state), 4, str(tmp_path))
    loaded, step = load_checkpoint(str(tmp_path), state)
    assert step == 4
    _same(loaded, state)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mixtral-8x7b"])
def test_train_state_round_trips_between_packages(arch, tmp_path):
    """A whole train state (mixtral's m and v are bf16): the reference's
    save loads in the port as ``train_state_from_numpy`` builds it, and
    the port's save of it loads back in the reference unchanged."""
    cfg = get(arch).tiny()
    jstate = jsteps.init_train_state(cfg, jax.random.PRNGKey(0), JHP())
    jstate = jax.tree.map(lambda x: x + jnp.ones_like(x), jstate)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                    "cpu")
    jsave(jstate, 1, str(tmp_path / "ref"))
    loaded, _ = load_checkpoint(str(tmp_path / "ref"), tstate)
    _same(loaded, tstate)
    save_checkpoint(tstate, 1, str(tmp_path / "port"))
    back, _ = jload(str(tmp_path / "port"), jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
