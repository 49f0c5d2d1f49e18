"""``repro_torch.sharding`` — the reference's logical-axis rules, carried
onto processes that each hold their own shard (see :mod:`.rules`), and
FSDP over the data axis (:mod:`.fsdp`)."""
from . import fsdp
from .rules import (
    LOGICAL_RULES, axis_size, current_mesh, current_rules, local_shard,
    logical_spec, resolved_axes, shard, shard_shape, sharding_ctx,
)

__all__ = [
    "LOGICAL_RULES", "axis_size", "logical_spec", "local_shard",
    "resolved_axes", "shard", "shard_shape", "sharding_ctx",
    "current_mesh", "current_rules", "fsdp",
]
