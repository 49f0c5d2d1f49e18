"""``repro_torch`` — the PyTorch/CUDA port of the ``repro`` package.

The port serves the same models through the same UMT runtime on an NVIDIA
Hopper card.  Plain tensor code is PyTorch; every Pallas kernel of the
reference on the served path is a hand-written Hopper kernel
(``repro_torch.kernels``): CUDA C++ for ``sm_90a`` under ``csrc/`` built
with ``nvcc`` and bound through ``ctypes``, or Triton.  Each kernel keeps a
plain PyTorch version beside it; a wrapper takes the plain version only for
tensors that lie on the CPU.

Entry points take ``device=`` and default to ``"cuda"``; asking for
``"cuda"`` on a machine without a card raises (see :func:`resolve_device`).
The package imports nothing from ``repro`` and never imports ``jax``: the
modules it shares with the reference (``configs``, ``core``, the pager, the
policy and the request plumbing) are copies, held equal to their originals
by ``tests/test_torch_imports.py``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
