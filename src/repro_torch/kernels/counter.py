"""Launch counters: one per kernel wrapper, bumped where the wrapper
launches its kernel and nowhere else, so a run can show that its main
path went through the kernel.  Serve tasks launch from several worker
threads, hence the lock."""
from __future__ import annotations

import threading


class LaunchCounter:
    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def forward_only(name, *tensors) -> None:
    """Raise where autograd would record a kernel that has no backward:
    its output would carry no gradient to its inputs, and everything
    below it would silently get none.  Called on the CUDA branch of a
    wrapper; the CPU branch takes the plain version, which autograd
    differentiates."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward, so it cannot run "
            "under autograd: train mode attends through plain "
            "full_attention, as the reference does, and the paged decodes "
            "never train; call it under torch.no_grad()")
