"""Hand-written Hopper kernels of the port, one package per TPU kernel
of the reference, each with its plain PyTorch version and a launch
counter on its wrapper:

  * paged_attention — paged GQA decode (``csrc/paged_decode.cu``) and
    paged absorbed-MLA decode (``csrc/paged_mla_decode.cu``), CUDA C++
  * rmsnorm         — RMSNorm, Triton
  * ssd_chunk       — Mamba2 SSD chunk scan, CUDA C++ (``csrc/ssd_chunk.cu``)

Still to port (see ROADMAP.md queue 2): flash attention.
"""
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_ref,
                              paged_mla_decode_attention,
                              paged_mla_decode_attention_ref)
from .rmsnorm import rms_norm, rms_norm_ref
from .ssd_chunk import ssd_scan, ssd_scan_ref

__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "paged_mla_decode_attention", "paged_mla_decode_attention_ref",
           "rms_norm", "rms_norm_ref", "ssd_scan", "ssd_scan_ref"]
