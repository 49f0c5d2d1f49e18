"""The training path inside the port, on the CPU: the reference's
system bars (``tests/test_system.py``) on the port's loop — the loss
falls, a checkpoint restart is equivalent to the straight run,
preemption checkpoints and resumes, and prefetch and checkpoint writes
run as UMT tasks — plus jamba-v0.1-52b's train step against the
reference's, remat against none, ``softmax_xent`` and
``_token_loss`` against the reference's, and the CLI
(``repro_torch.launch.train``): a resumed run continues the straight
run's losses, UMT on and off give the same losses, the audio frontend
trains, and the vision frontend is refused (the reference's CLI has no
patches to feed it).

Tolerances: params after a restart rtol 1e-5 / atol 1e-6, the
reference's bar (``tests/test_system.py:71-75``; the port's CPU step is
deterministic, so they are in fact equal); remat against none, loss and
gradients rtol 1e-6 (the recomputed forward is the same arithmetic);
``softmax_xent`` rtol 1e-6 (XLA and PyTorch reduce the vocab in another
order); CLI losses equal to the printed 4 decimals.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.configs import get
from repro.models.layers import softmax_xent as jxent
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import UMTRuntime
from repro_torch.data import SyntheticTokenSource, UMTPrefetcher, \
    batch_for_step
from repro_torch.launch import train as cli
from repro_torch.models.layers import softmax_xent, tree_leaves, tree_map
from repro_torch.optim import OptHParams
from repro_torch.steps import (_token_loss, init_train_state,
                               make_grad_step, make_train_step)

CFG = get("qwen2.5-14b").tiny()
HP = OptHParams(lr=1e-3, warmup=3, total_steps=100)


def _batch(step, cfg=CFG):
    return batch_for_step(step, seed=11, batch=4, seq=32, vocab=cfg.vocab,
                          accum=2)


def _state(seed=0, cfg=CFG):
    return init_train_state(cfg, torch.Generator().manual_seed(seed), HP,
                            "cpu")


def _train(state, step_fn, steps, start=0):
    losses = []
    for s in range(start, start + steps):
        state, m = step_fn(state, _batch(s))
        losses.append(float(m["loss"]))
    return state, losses


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def test_train_step_matches_reference_hybrid():
    """jamba-v0.1-52b: SSD, attention and MoE in one pattern
    (``tests/test_torch_train.py`` holds the other four families and
    states the tolerances)."""
    from test_torch_train import check_step_against_reference

    check_step_against_reference("jamba-v0.1-52b")


def test_training_reduces_loss():
    _, losses = _train(_state(), make_train_step(CFG, HP), 25)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.05, (first, last)


def test_checkpoint_restart_is_equivalent(tmp_path):
    """Interrupt at step 5, restore, continue -> same params at step 10."""
    step_fn = make_train_step(CFG, HP)
    straight, _ = _train(_state(), step_fn, 10)

    state, _ = _train(_state(), step_fn, 5)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 5, wait=True)
    del state

    restored, rstep = mgr.restore(_state(seed=1))
    assert rstep == 5 and int(restored["step"]) == 5
    resumed, _ = _train(restored, step_fn, 5, start=5)
    for a, b in zip(tree_leaves(straight["params"]),
                    tree_leaves(resumed["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_preemption_checkpoints_and_resumes(tmp_path):
    step_fn = make_train_step(CFG, HP)
    state = _state()
    mgr = CheckpointManager(str(tmp_path))
    for s in range(10):
        state, _ = step_fn(state, _batch(s))
        if s == 3:
            mgr.request_preemption()
        if mgr.preempted.is_set():
            mgr.save(state, s + 1, wait=True)
            break
    assert mgr.latest_step() == 4
    restored, rstep = mgr.restore(state)
    assert rstep == 4
    assert int(restored["step"]) == 4


def test_host_runtime_carries_prefetch_and_checkpoint(tmp_path):
    step_fn = make_train_step(CFG, HP)
    state = _state()
    src = SyntheticTokenSource(seed=11, batch=4, seq=32, vocab=CFG.vocab,
                               accum=2)
    with UMTRuntime(n_cores=2, umt=True) as rt:
        mgr = CheckpointManager(str(tmp_path), rt=rt)
        pf = UMTPrefetcher(src, rt, depth=2)
        for s in range(6):
            state, _ = step_fn(state, pf.get(s))
            mgr.save(state, s + 1, wait=False)
        mgr.wait()
        stats = rt.stats()
    assert mgr.latest_step() == 6
    kinds = {e[4] for e in rt.tracer.events if e[1] == "task_start"}
    assert any(k and k.startswith("prefetch") for k in kinds)
    assert any(k and k.startswith("ckpt") for k in kinds)
    assert stats["n_events"] > 0


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mixtral-8x7b",
                                  "mamba2-780m"])
def test_remat_full_equals_none(arch):
    """``remat="full"`` (every registry config's) checkpoints each repeat,
    and ``"dots"`` each repeat saving its products' outputs; the
    recomputed forward gives the same loss and gradients.  A remat name
    of neither kind raises."""
    cfg = get(arch).tiny()
    state = _state(cfg=cfg)
    batch = _batch(0, cfg)
    g0, l0 = make_grad_step(cfg)(state["params"], batch)
    for remat in ("full", "dots"):
        g1, l1 = make_grad_step(cfg.replace(remat=remat))(state["params"],
                                                          batch)
        np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
        for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                       atol=1e-9)
    with pytest.raises(ValueError, match="remat='offload'"):
        make_grad_step(cfg.replace(remat="offload"))(state["params"], batch)


def test_softmax_xent_and_token_loss_match_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50), np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -1                                  # masked
    labels[2, 6] = -1
    for z in (0.0, 1e-4, 0.1):
        want = np.asarray(jxent(jnp.asarray(logits), jnp.asarray(labels),
                                z))
        got = softmax_xent(torch.tensor(logits), torch.tensor(labels), z)
        live = labels >= 0
        np.testing.assert_allclose(got.numpy()[live], want[live], rtol=1e-6)
        cfg = CFG.replace(z_loss=z)
        jl = jsteps._token_loss({"logits": jnp.asarray(logits)},
                                jnp.asarray(labels), cfg)
        tl = _token_loss({"logits": torch.tensor(logits)},
                         torch.tensor(labels), cfg)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    # bf16 logits: the loss is still taken in f32
    lb = torch.tensor(logits).bfloat16()
    assert softmax_xent(lb, torch.tensor(labels)).dtype == torch.float32


def _cli(argv):
    """The CLI's JSON lines (per-step lines and the closing line)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.train(argv)
    return [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith("{")]


def test_cli_trains_the_audio_frontend():
    """musicgen-large trains a tiny run through the CLI on (…, K) codebook
    batches (``SyntheticTokenSource(extra_dim=n_codebooks)``, as the
    reference's CLI): its losses are those of ``make_train_step`` driven
    by hand from the same seeded state over the same batches, to the
    printed 4 decimals, and finite."""
    steps = 4
    run = _cli(["--arch", "musicgen-large", "--tiny", "--device", "cpu",
                "--steps", str(steps), "--batch", "4", "--seq", "16",
                "--log-every", "1"])
    got = [ln["loss"] for ln in run if "step" in ln]
    cfg = get("musicgen-large").tiny()
    hp = OptHParams(lr=3e-4, warmup=5, total_steps=steps)
    state = init_train_state(cfg, torch.Generator("cpu").manual_seed(0), hp,
                             "cpu")
    src = SyntheticTokenSource(seed=1234, batch=4, seq=16, vocab=cfg.vocab,
                               extra_dim=cfg.n_codebooks)
    step_fn, want = make_train_step(cfg, hp), []
    for step in range(steps):
        batch = src.fetch(step)
        assert batch["tokens"].shape == (1, 4, 16, cfg.n_codebooks)
        state, m = step_fn(state, batch)
        want.append(round(float(m["loss"]), 4))
    assert got == want and all(np.isfinite(got))


def test_cli_refuses_the_vision_frontend():
    """The reference's CLI feeds internvl2-2b no patch embeddings and its
    forward asserts them; the port refuses with the reason, and invents
    no patches."""
    with pytest.raises(ValueError, match="no patch embeddings"):
        cli.train(["--arch", "internvl2-2b", "--tiny", "--device", "cpu",
                   "--steps", "1"])


def test_cli_resumes_and_umt_does_not_change_the_losses(tmp_path):
    """A run of 7 of the 12 steps saves at step 6 (its schedule is the
    12-step run's through step 6: the same warmup, and cosine at t=0 at
    step 5); the resumed 12-step run continues from there."""
    base = ["--tiny", "--device", "cpu", "--steps", "12", "--batch", "4",
            "--seq", "16", "--log-every", "1", "--ckpt-every", "6"]
    straight = _cli(base)
    _cli(base[:4] + ["7"] + base[5:] + ["--ckpt-dir", str(tmp_path)])
    resumed = _cli(base + ["--ckpt-dir", str(tmp_path), "--resume"])
    off = _cli(base + ["--umt-off"])
    steps = {ln["step"]: ln["loss"] for ln in straight if "step" in ln}
    assert len(steps) == 12
    again = {ln["step"]: ln["loss"] for ln in resumed if "step" in ln}
    assert sorted(again) == list(range(6, 12))       # from the step-6 save
    assert all(again[s] == steps[s] for s in again), (again, steps)
    assert [ln["loss"] for ln in off if "step" in ln] == \
        [steps[s] for s in range(12)]
    for run in (straight, resumed, off):
        assert {"wall_s", "host_cpu_util", "host_wakes"} <= set(run[-1])
