"""Roofline terms, collective bytes and analytic model FLOPs (PyTorch port
of ``repro/launch/hlo_analysis.py``).

``model_flops``, ``active_params`` and ``total_params`` and their helpers
are the reference's, as code: the same configs give the same numbers.
``Roofline`` is for NVIDIA H100 SXM cards (NVIDIA's data sheet, dense
rates at the 700 W limit): 989 TFLOP/s in bf16 on the tensor cores and
3.35 TB/s of HBM a card, in place of the reference's TPU v5e constants,
and ``chips`` of them, with the reference's ``as_dict`` keys.

``collective_stats`` counts the collectives of a step run on a layout
mesh (``launch.mesh.LayoutMesh.records``: kind, axis, group size, result
bytes) where the reference parses them out of XLA's post-partitioning
HLO text, which PyTorch does not produce; the bytes moved per chip are
the reference's ring formulas (``repro/launch/hlo_analysis.py:75-109``):
an all-reduce ``2 (n - 1) / n`` of its result, an all-gather (and any
other kind) ``(n - 1) / n``.  ``measure`` is not ported: the port's op
counts come from the aten ops that run (``launch/op_cost.py``).

``LINK_BW`` turns those bytes into ``t_collective``.  It is NVIDIA's data
sheet for the H100 SXM, not measured: fourth-generation NVLink, 900 GB/s
a GPU summed over both directions, so 450 GB/s out of each GPU.  On a
16x16 layout the model axis's 16 GPUs span two 8-GPU HGX boards, so its
rings cross the NVLink Switch System's second level, whose data-sheet
rate per GPU is the same 900 GB/s; the data and pod axes are charged the
same rate here, as the reference charges one ICI rate to every axis
(over InfiniBand, 400 Gb/s a GPU, they would take 9 times as long).
"""
from __future__ import annotations

from dataclasses import dataclass, field

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores, one H100 SXM
HBM_BW = 3.35e12           # bytes/s, one H100 SXM
LINK_BW = 450e9            # bytes/s out of one H100 SXM over NVLink 4
LINK_SOURCE = ("NVIDIA H100 SXM data sheet: NVLink 900 GB/s a GPU both "
               "directions (450 GB/s each way), the model axis of a 16x16 "
               "layout across the NVLink Switch System; from the data "
               "sheet, not measured")


@dataclass
class CollectiveStats:
    per_chip_bytes: float = 0.0          # ring-model bytes crossing links
    payload_bytes: float = 0.0           # raw result-shape bytes (per chip)
    by_kind: dict = field(default_factory=dict)
    count: int = 0


def collective_stats(records) -> CollectiveStats:
    """The collectives ``records`` (``(kind, axis, group size, result
    bytes)``, as ``LayoutMesh`` keeps them) as the reference counts them:
    per kind ``[count, bytes moved per chip]``, and the totals."""
    st = CollectiveStats()
    for kind, _, n, size in records:
        if n <= 1 or size == 0:
            continue
        frac = (n - 1) / n
        moved = 2 * size * frac if kind == "all-reduce" else size * frac
        st.per_chip_bytes += moved
        st.payload_bytes += size
        k = st.by_kind.setdefault(kind, [0, 0.0])
        k[0] += 1
        k[1] += moved
        st.count += 1
    return st


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes_per_chip: float = 0.0
    chips: int = 1

    @property
    def t_compute(self):
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self):
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self):
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self):
        """The least time the cards could take: the largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self):
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "flops_global": self.flops,
            "hbm_bytes_global": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "chips": self.chips,
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
