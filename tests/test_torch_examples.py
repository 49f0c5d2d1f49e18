"""The port's examples (``repro_torch.examples``) run to their end on the
CPU, each in a process of its own under a deadline, at a tiny size.
No timing is asserted: the UMT legs' walls are the card run's to report
(``chip_smoke.check_examples``), and timings under a loaded test run
flake."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 240


def _run(name, *argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=DEADLINE_S)
    assert out.returncode == 0, out.stderr[-3000:] + out.stdout[-3000:]
    return out.stdout


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_quickstart():
    out = _run("quickstart", "--device", "cpu")
    assert out.count("4 x 0.2s blocking ops") == 2
    assert "step 9: loss" in out and "training a tiny mixtral" in out


def test_serve_batch():
    oneshot, engine = _json_lines(_run("serve_batch", "--device", "cpu"))
    assert oneshot["mode"] == "oneshot" and engine["mode"] == "engine"
    assert oneshot["generated_shape"] == [4, 12]
    assert engine["generated_shape"] == [8, 12]
    # the engine's first requests are the one-shot batch's prompts
    assert engine["sample"] == oneshot["sample"]


def test_train_100m_trains_and_resumes(tmp_path):
    small = ["--device", "cpu", "--d-model", "64", "--n-layers", "2",
             "--vocab", "256", "--log-every", "1", "--ckpt-every", "2",
             "--ckpt-dir", str(tmp_path)]
    first = _json_lines(_run("train_100m", "--steps", "3", *small))
    assert [ln["step"] for ln in first if "step" in ln] == [0, 1, 2]
    out = _run("train_100m", "--steps", "4", *small)
    assert "resumed from step 2" in out
    steps = [ln for ln in _json_lines(out) if "step" in ln]
    assert [ln["step"] for ln in steps] == [2, 3]
    assert steps[0]["loss"] == [ln for ln in first
                                if ln.get("step") == 2][0]["loss"]


def test_io_overlap_demo():
    out = _run("io_overlap_demo", "--device", "cpu", "--steps", "3",
               "--d-model", "64")
    assert "baseline (sync ckpt):" in out and "UMT (overlapped ckpt):" in out


def test_examples_ask_for_the_card():
    from repro_torch.examples import io_overlap_demo, quickstart

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (quickstart.main, io_overlap_demo.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
