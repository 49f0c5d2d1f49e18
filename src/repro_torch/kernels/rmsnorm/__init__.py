from .ops import (RMSNormFn, RMSNormRstdFn, rms_norm, rms_norm_bwd,
                  rms_norm_bwd_rstd, rms_norm_dot, rms_norm_rstd)
from .ref import (rms_norm_bwd_ref, rms_norm_bwd_rstd_ref, rms_norm_dot_ref,
                  rms_norm_ref, rms_norm_rstd_ref)

__all__ = ["RMSNormFn", "RMSNormRstdFn", "rms_norm", "rms_norm_bwd",
           "rms_norm_bwd_ref", "rms_norm_bwd_rstd", "rms_norm_bwd_rstd_ref",
           "rms_norm_dot", "rms_norm_dot_ref", "rms_norm_ref",
           "rms_norm_rstd", "rms_norm_rstd_ref"]
