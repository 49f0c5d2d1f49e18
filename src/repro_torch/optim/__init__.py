from .adamw import OptHParams, adamw_init, adamw_update, global_norm, \
    lr_schedule
from .compress import compress_grads, decompress_grads, ef_init

__all__ = ["adamw_init", "adamw_update", "global_norm", "OptHParams",
           "lr_schedule", "compress_grads", "decompress_grads", "ef_init"]
