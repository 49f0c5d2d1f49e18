from .ops import RMSNormFn, rms_norm, rms_norm_bwd
from .ref import rms_norm_bwd_ref, rms_norm_ref

__all__ = ["RMSNormFn", "rms_norm", "rms_norm_bwd", "rms_norm_bwd_ref",
           "rms_norm_ref"]
