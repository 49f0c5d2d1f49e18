from .ops import RMSNormFn, rms_norm, rms_norm_bwd, rms_norm_rstd
from .ref import rms_norm_bwd_ref, rms_norm_ref, rms_norm_rstd_ref

__all__ = ["RMSNormFn", "rms_norm", "rms_norm_bwd", "rms_norm_bwd_ref",
           "rms_norm_ref", "rms_norm_rstd", "rms_norm_rstd_ref"]
