"""Hand-written Hopper kernels of the port, one package per TPU kernel
of the reference, each with its plain PyTorch version and a launch
counter on its wrapper:

  * paged_attention — paged GQA decode, CUDA C++ (``csrc/paged_decode.cu``)
  * rmsnorm         — RMSNorm, Triton

Still to port (see ROADMAP.md queue 2): flash attention, paged MLA decode,
the SSD chunk scan.
"""
from .paged_attention import paged_decode_attention, paged_decode_attention_ref
from .rmsnorm import rms_norm, rms_norm_ref

__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "rms_norm", "rms_norm_ref"]
