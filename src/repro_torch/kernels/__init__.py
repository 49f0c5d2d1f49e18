"""Hand-written Hopper kernels of the port, one package per TPU kernel
of the reference, each with its plain PyTorch version and a launch
counter on its wrapper:

  * flash_attention — tiled causal / sliding-window GQA attention, the
    prefill's, CUDA C++ (``csrc/flash_attention.cu``)
  * paged_attention — paged GQA decode (``csrc/paged_decode.cu``) and
    paged absorbed-MLA decode (``csrc/paged_mla_decode.cu``), CUDA C++
  * rmsnorm         — RMSNorm, Triton
  * ssd_chunk       — Mamba2 SSD chunk scan, CUDA C++ (``csrc/ssd_chunk.cu``)

Every TPU kernel of the reference now has its Hopper counterpart here.
"""
from .flash_attention import flash_attention, flash_attention_ref
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_ref,
                              paged_mla_decode_attention,
                              paged_mla_decode_attention_ref)
from .rmsnorm import rms_norm, rms_norm_ref
from .ssd_chunk import ssd_scan, ssd_scan_ref

__all__ = ["flash_attention", "flash_attention_ref",
           "paged_decode_attention", "paged_decode_attention_ref",
           "paged_mla_decode_attention", "paged_mla_decode_attention_ref",
           "rms_norm", "rms_norm_ref", "ssd_scan", "ssd_scan_ref"]
