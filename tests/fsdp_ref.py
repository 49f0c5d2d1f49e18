"""The reference runs and bars that ``tests/test_torch_fsdp.py`` and
``tests/test_torch_fsdp_checkpoint.py`` hold the port's sharded train
state to: the reference's single-device ``jax.jit(make_train_step(cfg,
None, hp))`` from its ``init_train_state``, on batches made from a numpy
seed, and the comparison of a port run with it.

The bars are ``tests/test_torch_train.py``'s, carried over several steps:
each step's loss within rtol 1e-5 and grad norm within rtol 1e-4; at the
end every param leaf within rtol 1e-5 / atol 1e-6, but for the elements
whose clipped gradient (recovered from the reference's m, ``m = b1 m' +
(1 - b1) g``) lay at some step between 0 and ``SENSITIVE``.  There
AdamW's ``g / (sqrt(v) + eps)`` turns on the gradient's last bits
(``eps`` is 1e-8: at 1e-6 it weighs 1 % in the denominator, and an
element a few eps across takes a step anywhere up to lr), so such an
element is held within 2 lr a step.  ``test_torch_train.py`` draws that
line at 1e-7 after one step; after three, single elements whose gradient
was 5e-9 or 2.8e-7 at one step (qwen2.5-14b's w_up and embedding) moved
by 2.1e-6 and 2.3e-6 in the port's own single-device run, and by
1.3-2.9e-6 in its sharded ones, so the line here is 1e-6.  m and v by
their relative L2 error per leaf, 1e-4.  Sharded or whole, the ranks sum the
same f32 products in another order; that is all the bars allow for.
"""
import sys
from pathlib import Path
from typing import NamedTuple

import jax
import numpy as np
import torch

from repro import steps as jsteps
from repro.configs import get as jget
from repro.data import batch_for_step
from repro.optim import OptHParams as JHP
from repro_torch.configs import get
from repro_torch.launch.train import MeshTrain
from repro_torch.optim import OptHParams
from repro_torch.params import train_state_from_numpy
from repro_torch.serve.tp import counters

# the planted faults are chip_smoke's (``fsdp_on``), which a follower
# unpickles by name: the repo root goes on the path the followers inherit
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

HP = dict(lr=1e-3, warmup=3, total_steps=100)
SENSITIVE = 1e-6
STEPS, MICRO, ACCUM, SEQ = 3, 4, 2, 16


def batches(cfg, micro=MICRO, accum=ACCUM, steps=STEPS, masked=True,
            seed=11):
    """``steps`` batches of ``accum`` x ``micro`` x ``SEQ``: labels a copy
    of the tokens, with -1 in uneven runs when ``masked`` (one
    microbatch's row 0 loses most of its labels, the last row of another
    a few, row 1 of a third its second half), patches for vision, a
    codebook axis for audio."""
    audio = cfg.frontend == "audio_codebooks"
    rng = np.random.default_rng(seed)
    out = []
    for k in range(steps):
        b = batch_for_step(k, seed=seed, batch=accum * micro, seq=SEQ,
                           vocab=cfg.vocab, accum=accum,
                           extra_dim=cfg.n_codebooks if audio else 0)
        labels = b["labels"].copy()
        if masked:
            labels[0, 0, :12] = -1
            labels[accum - 1, micro - 1, rng.integers(0, SEQ, 3)] = -1
            labels[k % accum, 1, SEQ // 2:] = -1
        b = {"tokens": b["tokens"], "labels": labels}
        if cfg.frontend == "vision_patches":
            b["patches"] = rng.standard_normal(
                (accum, micro, cfg.n_patches, cfg.d_model)).astype(
                    np.float32)
        out.append(b)
    return out


class Ref(NamedTuple):
    """A reference run: its first state, its batches, each step's
    metrics, each step's state (numpy) and, per param leaf, the elements
    whose gradient lay in (0, ``SENSITIVE``) at some step up to each."""
    state0: dict
    batches: list
    metrics: list
    states: list
    small: list


_REF = {}


def reference(arch, micro=MICRO, accum=ACCUM, steps=STEPS, masked=True,
              **over):
    """The reference's run of ``arch``'s tiny config (``over``: config
    overrides), cached."""
    key = (arch, micro, accum, steps, masked, tuple(sorted(over.items())))
    if key in _REF:
        return _REF[key]
    jcfg = jget(arch).tiny(**over)
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0), JHP(**HP))
    state0 = jax.tree.map(np.asarray, jstate)
    bs = batches(jcfg, micro, accum, steps, masked)
    step = jax.jit(jsteps.make_train_step(jcfg, None, JHP(**HP)))
    b1 = JHP().b1
    metrics, states, small, now = [], [], [], None
    for b in bs:
        m0 = [np.asarray(x) for x in jax.tree.leaves(jstate["opt"]["m"])]
        jstate, m = step(jstate, b)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(jax.tree.map(np.asarray, jstate))
        g = [np.abs((np.asarray(x) - b1 * y) / (1 - b1)) for x, y in
             zip(jax.tree.leaves(jstate["opt"]["m"]), m0)]
        this = [(x > 0) & (x < SENSITIVE) for x in g]
        now = this if now is None else [a | c for a, c in zip(now, this)]
        small.append(now)
    _REF[key] = Ref(state0, bs, metrics, states, small)
    return _REF[key]


def whole_leaves(tr):
    """A ``MeshTrain``'s state, each leaf assembled whole (the
    checkpoint's snapshot), in ``tree_leaves`` order."""
    return [torch.from_numpy(raw.copy()).view(getattr(torch, dt)).reshape(
        shape) for raw, shape, dt in tr._snapshot(tr.state)]


def mesh_train(arch, mesh, state0, **over):
    """A ``MeshTrain`` of ``arch``'s tiny config on ``mesh`` from the
    whole numpy train state ``state0``."""
    cfg = get(arch).tiny(**over)
    return MeshTrain(cfg, OptHParams(**HP), mesh, "cpu",
                     train_state_from_numpy(state0, cfg, "cpu"))


def run_mesh(arch, mesh, ref, fault=None, **over):
    """``ref``'s steps on ``mesh`` from its first state (fault ``fault``
    planted on every rank): (metrics per step, whole leaves at the end,
    per-rank counters of the last step)."""
    tr = mesh_train(arch, mesh, ref.state0, **over)
    try:
        if fault:
            tr.sess.run(chip_smoke.fsdp_on, fault)
        metrics = []
        for b in ref.batches:
            tr.sess.run(counters, True)
            tr.state, m = tr.step(tr.state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        count = tr.sess.run(counters)
        if fault:
            tr.sess.run(chip_smoke.fsdp_off, fault)
        return metrics, whole_leaves(tr), count
    finally:
        tr.close()


def misses(ref, metrics, leaves, first=0):
    """What of the bars (the module's docstring) a port run misses, as a
    list of messages (empty when every bar holds): ``metrics`` of the
    reference's steps ``first`` onward, ``leaves`` the whole state (in
    ``tree_leaves`` order: m, v, params, step) after the last of them."""
    out = []
    for k, (g, w) in enumerate(zip(metrics, ref.metrics[first:]), first):
        if not np.isclose(g["loss"], w["loss"], rtol=1e-5, atol=0):
            out.append(f"step {k} loss {g['loss']} vs {w['loss']}")
        if not np.isclose(g["grad_norm"], w["grad_norm"], rtol=1e-4,
                          atol=0):
            out.append(f"step {k} grad norm {g['grad_norm']} vs "
                       f"{w['grad_norm']}")
    last = first + len(metrics) - 1
    jstate = ref.states[last]
    n = len(jax.tree.leaves(jstate["params"]))
    jl = jax.tree.leaves(jstate)
    jm, jv, jp = jl[:n], jl[n:2 * n], jl[2 * n:3 * n]
    tm, tv, tp = leaves[:n], leaves[n:2 * n], leaves[2 * n:3 * n]
    for i, (t, j, small) in enumerate(zip(tp, jp, ref.small[last])):
        got, j = t.float().numpy(), np.asarray(j, np.float32)
        gap = np.abs(got - j)
        if not np.allclose(got[~small], j[~small], rtol=1e-5, atol=1e-6):
            out.append(f"param leaf {i}: max |diff| {gap[~small].max():.3e}"
                       f" at element {np.argmax(gap * ~small)}")
        if gap.max() > 2 * HP["lr"] * (last + 1):
            out.append(f"param leaf {i}: an element off by more than 2 lr "
                       "a step")
    for what, ts, js in (("m", tm, jm), ("v", tv, jv)):
        for i, (t, j) in enumerate(zip(ts, js)):
            j = np.asarray(j, np.float32)
            rel = np.linalg.norm(t.float().numpy() - j) / (
                np.linalg.norm(j) or 1.0)
            if rel > 1e-4:
                out.append(f"{what} leaf {i}: rel {rel:.3e}")
    if int(leaves[-1]) != last + 1:
        out.append(f"step counter {int(leaves[-1])}, want {last + 1}")
    return out
