"""Boundaries of the port: ``repro_torch`` imports neither ``jax`` nor any
``repro.`` module, asks for the card by default and raises without one,
and its copies of the reference's JAX-free modules have not drifted."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
# the reference modules the port carries as copies (same relative path)
COPIES = sorted(
    [p.relative_to(REF) for p in (REF / "configs").glob("*.py")]
    + [p.relative_to(REF) for p in (REF / "core").glob("*.py")]
    + [Path("serve/pager.py"), Path("serve/policy.py"),
       Path("serve/prefix.py"), Path("serve/request.py")])


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(PORT.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax_and_no_reference_module():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr + out.stdout
    assert len(_port_modules()) > 20


def test_cuda_is_the_default_and_raises_without_a_card():
    from repro_torch import resolve_device
    from repro_torch.configs import get
    from repro_torch.models.lm import init_params
    from repro_torch.serve import ServeEngine

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get("qwen2.5-14b").tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, lambda: None)
    assert resolve_device("cpu").type == "cpu"


# The one change a copy carries: the port's runtime repairs the race in
# which ``shutdown`` joins a worker the leader has spawned but not yet
# started (``tests/test_torch_runtime.py``).  (original, repaired) pairs.
RUNTIME_FIX = [
    ("""        self._workers: list[Worker] = []
""",
     """        self._workers: list[Worker] = []
        self._spawn_lock = threading.Lock()       # spawn vs shutdown
"""),
    ("""        self.wait_all()
        self.running = False
""",
     """        self.wait_all()
        with self._spawn_lock:      # no spawn once running is false
            self.running = False
"""),
    ("""    def _spawn(self, core: int) -> Worker:
        w = Worker(self, core)
        self._workers.append(w)
        self.stats_extra["spawned"] += 1
        w.start()
        return w
""",
     """    def _spawn(self, core: int) -> Worker | None:
        \"\"\"Start a worker on ``core``; None once shut down.  A worker
        joins ``_workers`` only after ``start()``, under the lock that
        ``shutdown`` holds to clear ``running``, so shutdown never joins
        a worker that was not started.\"\"\"
        with self._spawn_lock:
            if not self.running:
                return None
            w = Worker(self, core)
            w.start()
            self._workers.append(w)
            self.stats_extra["spawned"] += 1
        return w
"""),
]


@pytest.mark.parametrize("rel", [str(p) for p in COPIES])
def test_copies_equal_their_originals(rel):
    """Each copy equals its original once the package path is replaced
    (``repro.`` -> ``repro_torch.``); the request module may differ only
    in its import of ``core``, the runtime only by ``RUNTIME_FIX``."""
    orig = re.sub(r"\brepro\.", "repro_torch.", (REF / rel).read_text())
    copy = (PORT / rel).read_text()
    if rel == str(Path("core/runtime.py")):
        for old, new in RUNTIME_FIX:
            assert orig.count(old) == 1, old
            orig = orig.replace(old, new)
    if rel == str(Path("serve/request.py")):
        def strip(s):
            return [ln for ln in s.splitlines()
                    if not ln.startswith("from ..core")]
        assert strip(copy) == strip(orig)
    else:
        assert copy == orig
