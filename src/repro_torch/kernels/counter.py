"""Launch counters: one per kernel wrapper, bumped where the wrapper
launches its kernel and nowhere else, so a run can show that its main
path went through the kernel.  Serve tasks launch from several worker
threads, hence the lock.  And the kernels' sites, where a cost model
(``launch/op_cost.OpCost``) charges a kernel's own work."""
from __future__ import annotations

import functools
import threading

# The devices whose tensors a wrapper hands to its kernel's plain version:
# the CPU (the tests' device) and ``meta``, which holds no data, so its
# "run" is a pass over shapes (the launch tools' dry run).  A CUDA tensor
# launches the kernel or raises; any other device raises.
PLAIN_DEVICES = ("cpu", "meta")


class LaunchCounter:
    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

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


def cost_model():
    """The innermost active cost model that charges kernels at their sites
    (an ``OpCost`` dispatch mode: it sets ``charges_kernels``), or None.
    Dispatch modes follow a step into its backward, so a backward's
    kernels find it too."""
    import torch
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "charges_kernels", False):
            return mode
    return None


def kernel_site(work):
    """Decorator of a kernel's wrapper: each call is a site of its kernel.
    Where a cost model is active (``cost_model``), the call is charged
    ``work(*args, **kwargs)``, the kernel's own (FLOPs, bytes moved), in
    place of the ops the call dispatches: on the card the launch's
    allocations, on the CPU or meta the plain version, whose work can be
    more than the kernel's (attention's full score square where the
    kernel skips the masked blocks).  Otherwise the call runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def site(*args, **kwargs):
            model = cost_model()
            if model is None:
                return fn(*args, **kwargs)
            return model.kernel(fn.__name__, lambda: work(*args, **kwargs),
                                fn, args, kwargs)
        return site
    return wrap
