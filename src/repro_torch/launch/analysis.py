"""Roofline terms and analytic model FLOPs (PyTorch port of
``repro/launch/hlo_analysis.py``).

``model_flops``, ``active_params`` and ``total_params`` and their helpers
are the reference's, as code: the same configs give the same numbers.
``Roofline`` is for one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W limit): 989 TFLOP/s in bf16 on the tensor cores and
3.35 TB/s of HBM, in place of the reference's TPU v5e constants.

Not ported: ``collective_stats`` and ``measure``.  Both read XLA's
post-partitioning HLO text, which PyTorch does not produce; the port's
counts come from the aten ops that run (``launch/op_cost.py``).  The
cost of a cell's collectives waits for the production meshes (ROADMAP.md
queue 1, item 20): ``Roofline`` is one card's, and its record keeps the
reference's collective keys at zero.
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores, one H100 SXM
HBM_BW = 3.35e12           # bytes/s, one H100 SXM


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float

    @property
    def t_compute(self):
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self):
        return self.hbm_bytes / HBM_BW

    @property
    def bottleneck(self):
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def t_bound(self):
        """The least time the card could take: the larger term."""
        return max(self.t_compute, self.t_memory)

    def as_dict(self):
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": 0.0,
            "bottleneck": self.bottleneck,
            "flops_global": self.flops,
            "hbm_bytes_global": self.hbm_bytes,
            "coll_bytes_per_chip": 0,
            "chips": 1,
        }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D for train (N = active params, D = tokens);
    2·N·D for inference steps."""
    n_active = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.batch * shape.seq
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.batch * shape.seq
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.batch  # decode: one token per sequence


def _attn_params(cfg, spec) -> float:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if spec.attn == "mla":
        rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return (d * rq + rq * h * (dn + dr) + d * (rkv + dr) +
                rkv * h * dn + rkv * h * dv + h * dv * d)
    return d * h * dh + 2 * d * hkv * dh + h * dh * d


def _ssm_params(cfg) -> float:
    d, di = cfg.d_model, cfg.d_inner
    cd = di + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return d * di + d * cd + d * cfg.ssm_nheads + di * d


def _mlp_params(cfg, spec, active: bool) -> float:
    if spec.mlp == "none":
        return 0.0
    dense = 3 * cfg.d_model * cfg.d_ff
    if spec.mlp == "dense":
        return dense
    e = cfg.top_k if active else cfg.n_experts
    return e * dense + cfg.d_model * cfg.n_experts


def _params_count(cfg, active: bool) -> float:
    total = 0.0
    for spec in cfg.pattern:
        mix = _ssm_params(cfg) if spec.kind == "ssm" else _attn_params(
            cfg, spec)
        total += mix + _mlp_params(cfg, spec, active)
    total *= cfg.n_repeats
    emb = cfg.vocab * cfg.d_model * cfg.n_codebooks
    total += 2 * emb  # embed + head
    return total


def active_params(cfg) -> float:
    return _params_count(cfg, active=True)


def total_params(cfg) -> float:
    return _params_count(cfg, active=False)
