"""Elastic re-mesh planning after host loss / shrink / grow.

Policy: the TP (`model`) axis is topology-bound (ICI ring) and is never
resized; capacity changes shrink or grow the pure-DP axes (`pod`, `data`).
A plan keeps global batch constant by rescaling gradient-accumulation
steps, so optimisation dynamics are unchanged across the restart —
checkpoints are mesh-portable (see checkpoint.manager), so the restart is
load-balanced from step ``resume_step``.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RemeshPlan:
    old_mesh: tuple[int, ...]
    new_mesh: tuple[int, ...]
    axis_names: tuple[str, ...]
    hosts_used: int
    chips_used: int
    accum_scale: int            # multiply accum steps by this
    note: str = ""

    @property
    def valid(self) -> bool:
        return all(d > 0 for d in self.new_mesh)


def plan_remesh(alive_hosts: int, *, chips_per_host: int = 4,
                old_mesh: tuple[int, ...] = (2, 16, 16),
                axis_names: tuple[str, ...] = ("pod", "data", "model"),
                global_batch: int = 256,
                micro_batch: int = 32) -> RemeshPlan:
    """Largest mesh using <= alive chips with the model axis preserved."""
    model = old_mesh[-1]
    old_dp = 1
    for d in old_mesh[:-1]:
        old_dp *= d
    chips = alive_hosts * chips_per_host
    dp_max = chips // model
    if dp_max < 1:
        return RemeshPlan(old_mesh, (0,) * len(old_mesh), axis_names,
                          alive_hosts, chips, 1,
                          note="not enough chips for one model replica")
    # keep dp a divisor of the global batch so accumulation stays integral
    dp = dp_max
    while dp > 1 and global_batch % dp != 0:
        dp -= 1
    if len(old_mesh) == 3:
        # fold dp into (pod, data): pods of 256 chips when possible
        pod_size = 256 // model if model <= 256 else 1
        pods = max(1, dp // max(pod_size, 1)) if pod_size else 1
        while pods > 1 and dp % pods != 0:
            pods -= 1
        new = (pods, dp // pods, model)
    else:
        new = (dp, model)
    accum_scale = max(1, old_dp // dp)
    return RemeshPlan(old_mesh, new, axis_names, alive_hosts,
                      dp * model, accum_scale,
                      note=f"dp {old_dp} -> {dp}; global batch kept at "
                           f"{global_batch} via accum x{accum_scale}")
