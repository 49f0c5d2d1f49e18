"""Hand-written Hopper kernels of the port, one package per TPU kernel
of the reference, each with its plain PyTorch version and a launch
counter on its wrapper:

  * flash_attention — tiled causal / sliding-window GQA attention, the
    prefill's, CUDA C++ (``csrc/flash_attention.cu``)
  * paged_attention — paged GQA decode (``csrc/paged_decode.cu``) and
    paged absorbed-MLA decode (``csrc/paged_mla_decode.cu``), CUDA C++
  * rmsnorm         — RMSNorm (and its entry with given row statistics,
    the tensor-parallel gated norm's) and the backward of both, Triton
  * ssd_chunk       — Mamba2 SSD chunk scan and its backward, CUDA C++
    (``csrc/ssd_chunk.cu``, ``csrc/ssd_chunk_bwd.cu``)

Every TPU kernel of the reference now has its Hopper counterpart here.
RMSNorm and the SSD scan have a backward on the card; flash attention and
the paged decodes raise under autograd (``counter.forward_only``): train
mode attends through plain ``full_attention``, as the reference does, and
the decodes never train.
"""
from .flash_attention import flash_attention, flash_attention_ref
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_ref,
                              paged_mla_decode_attention,
                              paged_mla_decode_attention_ref)
from .rmsnorm import (rms_norm, rms_norm_bwd, rms_norm_bwd_ref,
                      rms_norm_bwd_rstd, rms_norm_bwd_rstd_ref, rms_norm_dot,
                      rms_norm_dot_ref, rms_norm_ref, rms_norm_rstd,
                      rms_norm_rstd_ref)
from .ssd_chunk import ssd_scan, ssd_scan_bwd, ssd_scan_bwd_ref, ssd_scan_ref

__all__ = ["flash_attention", "flash_attention_ref",
           "paged_decode_attention", "paged_decode_attention_ref",
           "paged_mla_decode_attention", "paged_mla_decode_attention_ref",
           "rms_norm", "rms_norm_bwd", "rms_norm_bwd_ref",
           "rms_norm_bwd_rstd", "rms_norm_bwd_rstd_ref", "rms_norm_dot",
           "rms_norm_dot_ref", "rms_norm_ref", "rms_norm_rstd",
           "rms_norm_rstd_ref",
           "ssd_scan", "ssd_scan_bwd", "ssd_scan_bwd_ref", "ssd_scan_ref"]
