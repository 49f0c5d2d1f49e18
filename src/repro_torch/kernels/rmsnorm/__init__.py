from .ops import rms_norm
from .ref import rms_norm_ref

__all__ = ["rms_norm", "rms_norm_ref"]
