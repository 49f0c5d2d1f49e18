"""Config system: architecture + run-shape descriptions.

Every assigned architecture is a ``ModelConfig`` built from a repeating
``pattern`` of ``LayerSpec``s (the unit the layer scan iterates over), so the
lowered HLO is O(len(pattern)) rather than O(n_layers).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class LayerSpec:
    """One position inside an architecture's repeating block pattern."""

    kind: str = "attn"          # "attn" | "ssm"
    attn: str = "gqa"           # "gqa" | "mla"   (only if kind == "attn")
    window: int | None = None   # sliding-window size (SWA) or None
    mlp: str = "dense"          # "dense" | "moe" | "none"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    pos_emb: str = "rope"           # "rope" | "sinusoidal"
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_impl: str = "onehot"        # "onehot" (GShard-style) | "ragged" (dropless)
    # --- MLA (DeepSeek/MiniCPM3-style latent attention) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    # --- modality frontend (STUB: embeddings arrive precomputed) ---
    frontend: str = "none"          # "none" | "audio_codebooks" | "vision_patches"
    n_codebooks: int = 1            # audio: parallel EnCodec streams
    n_patches: int = 0              # vision: prepended patch embeddings
    # --- numerics / memory ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"    # master weights
    opt_dtype: str = "float32"      # AdamW m/v
    remat: str = "full"             # "none" | "dots" | "full"
    tie_embeddings: bool = False
    z_loss: float = 1e-4
    # long_500k applicability: sub-quadratic attention available?
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not a multiple of "
            f"pattern length {len(self.pattern)}")

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:  # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def tiny(self, **kw) -> "ModelConfig":
        """Reduced config of the same family for CPU smoke tests."""
        n_pat = len(self.pattern)
        base = dict(
            n_layers=2 * n_pat,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=4 if self.n_experts else 0,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            qk_nope_dim=8 if self.qk_nope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=8 if self.ssm_state else 256,
            n_patches=4 if self.n_patches else 0,
            remat="none",
            param_dtype="float32",
            dtype="float32",
            name=self.name + "-tiny",
        )
        base.update(kw)
        return self.replace(**base)


@dataclass(frozen=True)
class RunShape:
    """One assigned (seq_len, global_batch) cell."""

    name: str
    kind: str        # "train" | "prefill" | "decode"
    seq: int
    batch: int
    accum: int = 1   # gradient-accumulation microbatches (train only)


SHAPES: dict[str, RunShape] = {
    "train_4k":    RunShape("train_4k", "train", 4_096, 256, accum=8),
    "prefill_32k": RunShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  RunShape("decode_32k", "decode", 32_768, 128),
    "long_500k":   RunShape("long_500k", "decode", 524_288, 1),
}


def shapes_for(cfg: ModelConfig) -> list[RunShape]:
    """The runnable cells for an architecture (long_500k needs sub-quadratic)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        out.append(SHAPES["long_500k"])
    return out
