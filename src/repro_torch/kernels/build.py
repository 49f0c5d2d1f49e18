"""Build the CUDA sources under ``repro_torch/csrc`` with ``nvcc`` into a
shared library with a plain C interface, loaded through ``ctypes``.

The build runs at first use, never at import, from the checkout's own
sources into ``build/repro_torch/`` at the repository root (listed in
``.gitignore``).  The library's file name carries a hash of its sources
and flags, so an edited source builds anew and an unchanged one is
reused; the headers under ``csrc`` (``*.cuh``) go into every library's
hash.  A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()            # guards _locks
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}     # name -> {"seconds", "ptxas", "path"}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(cand)


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """The library ``name`` built from ``sources`` (``nvcc`` now unless the
    hashed library already exists), loaded once per process.  The build's
    seconds and ``ptxas`` log go to ``build_log[name]``.  Libraries of
    different names build in parallel when called from several threads."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        srcs = [CSRC / s for s in sources]
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in srcs + sorted(CSRC.glob("*.cuh")):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
        info = {"seconds": 0.0, "ptxas": "", "path": str(out)}
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {name} "
                                   f"(exit {proc.returncode}):\n{proc.stdout}")
            os.replace(tmp, out)
            info.update(seconds=time.perf_counter() - t0, ptxas=proc.stdout)
        build_log[name] = info
        _loaded[name] = ctypes.CDLL(str(out))
        return _loaded[name]
