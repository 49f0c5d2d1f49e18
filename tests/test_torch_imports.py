"""Boundaries of the port: ``repro_torch`` imports neither ``jax`` nor any
``repro.`` module (nor does a tensor-parallel follower process), asks for
the card by default and raises without one, and its copies of the
reference's JAX-free modules have not drifted."""
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
    + [p.relative_to(REF) for d in ("data", "ft")
       for p in (REF / d).glob("*.py")]
    + [Path("serve/pager.py"), Path("serve/policy.py"),
       Path("serve/prefix.py"), Path("serve/request.py"),
       Path("serve/spec.py")])


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(PORT.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


# modules the check must cover by name: the launch tools and the
# examples (entry points whose bodies run only under ``__main__``), and
# tensor parallelism's rules, mesh and dispatch
NAMED = {"repro_torch.launch.analysis", "repro_torch.launch.op_cost",
         "repro_torch.launch.specs", "repro_torch.launch.dryrun",
         "repro_torch.launch.profile_cell", "repro_torch.examples",
         "repro_torch.examples.quickstart", "repro_torch.examples.serve_batch",
         "repro_torch.examples.train_100m",
         "repro_torch.examples.io_overlap_demo", "repro_torch.sharding",
         "repro_torch.sharding.rules", "repro_torch.launch.mesh",
         "repro_torch.serve.tp"}


def test_port_imports_no_jax_and_no_reference_module():
    assert NAMED <= set(_port_modules()), NAMED - set(_port_modules())
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


def test_a_follower_process_imports_no_jax_and_no_reference_module():
    """A tensor-parallel follower (a process of its own, started by
    ``spawn``) after serving a session: neither ``jax`` nor ``repro.``."""
    import numpy as np

    import tp_faults
    from repro_torch.configs import get
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.serve import Request, ServeEngine, drain
    from repro_torch.serve.tp import SeededParams

    cfg = get("mamba2-780m").tiny()
    with make_mesh_from_devices("1,2", device_type="cpu") as mesh:
        eng = ServeEngine(cfg, SeededParams(0), slots=2, cache_len=16,
                          mesh=mesh, n_cores=3, device="cpu").start()
        reqs = [Request(i, np.arange(4 + i, dtype=np.int32),
                        max_new_tokens=3) for i in range(2)]
        for r in reqs:
            eng.submit(r)
        drain(eng, reqs, 60)
        eng = ServeEngine(cfg, SeededParams(0), slots=2, cache_len=16,
                          mesh=mesh, n_cores=3, device="cpu")
        mods = eng._tp.run(tp_faults.modules)
        eng.shutdown()
    assert mods[1] == [], mods[1]


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
