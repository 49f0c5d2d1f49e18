"""The 10 assigned architectures, exactly as specified in the brief.

Each entry cites its source tier. Patterns encode the per-layer structure the
scan repeats over (see base.LayerSpec).
"""
from __future__ import annotations

from .base import LayerSpec, ModelConfig

A = LayerSpec  # shorthand


def _jamba_pattern() -> tuple[LayerSpec, ...]:
    """Jamba block: 8 layers, attention at index 4 (1:7 attn:mamba ratio),
    MoE on every other layer (odd indices). [arXiv:2403.19887]"""
    out = []
    for i in range(8):
        kind = "attn" if i == 4 else "ssm"
        mlp = "moe" if i % 2 == 1 else "dense"
        out.append(A(kind=kind, mlp=mlp))
    return tuple(out)


# --- decoder-only over EnCodec tokens [arXiv:2306.05284; hf] -----------------
MUSICGEN_LARGE = ModelConfig(
    name="musicgen-large", d_model=2048, n_layers=48, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab=2048,
    pattern=(A(kind="attn", attn="gqa"),),
    pos_emb="sinusoidal", frontend="audio_codebooks", n_codebooks=4,
)

# --- Mamba+attn 1:7 interleave, MoE 16e top-2 [arXiv:2403.19887; hf] ---------
JAMBA_52B = ModelConfig(
    name="jamba-v0.1-52b", d_model=4096, n_layers=32, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab=65536,
    pattern=_jamba_pattern(),
    n_experts=16, top_k=2,
    ssm_state=16, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    subquadratic=True,  # only 4/32 layers attend; seq-sharded KV cache
    opt_dtype="bfloat16",
)

# --- SSD (state-space duality) [arXiv:2405.21060; unverified] ----------------
MAMBA2_780M = ModelConfig(
    name="mamba2-780m", d_model=1536, n_layers=48, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280,
    pattern=(A(kind="ssm", mlp="none"),),
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    subquadratic=True,
)

# --- MLA [hf:openbmb/MiniCPM3-4B; hf] ----------------------------------------
MINICPM3_4B = ModelConfig(
    name="minicpm3-4b", d_model=2560, n_layers=62, n_heads=40,
    n_kv_heads=40, d_ff=6400, vocab=73448,
    pattern=(A(kind="attn", attn="mla"),),
    q_lora_rank=768, kv_lora_rank=256, qk_rope_dim=32, qk_nope_dim=64,
    v_head_dim=64, head_dim=96,  # qk head dim = nope + rope
)

# --- GQA, QKV bias [hf:Qwen/Qwen2.5-*; hf] -----------------------------------
QWEN25_14B = ModelConfig(
    name="qwen2.5-14b", d_model=5120, n_layers=48, n_heads=40,
    n_kv_heads=8, d_ff=13824, vocab=152064,
    pattern=(A(kind="attn", attn="gqa"),), qkv_bias=True,
)

# --- [hf:mistralai/Mistral-Large-Instruct-2407; unverified] ------------------
MISTRAL_LARGE_123B = ModelConfig(
    name="mistral-large-123b", d_model=12288, n_layers=88, n_heads=96,
    n_kv_heads=8, d_ff=28672, vocab=32768,
    pattern=(A(kind="attn", attn="gqa"),),
    opt_dtype="bfloat16",
)

# --- QKV bias [hf:Qwen/Qwen1.5-*; hf] ----------------------------------------
QWEN15_110B = ModelConfig(
    name="qwen1.5-110b", d_model=8192, n_layers=80, n_heads=64,
    n_kv_heads=8, d_ff=49152, vocab=152064,
    pattern=(A(kind="attn", attn="gqa"),), qkv_bias=True,
    opt_dtype="bfloat16",
)

# --- InternViT + InternLM2 [arXiv:2404.16821; hf] ----------------------------
INTERNVL2_2B = ModelConfig(
    name="internvl2-2b", d_model=2048, n_layers=24, n_heads=16,
    n_kv_heads=8, d_ff=8192, vocab=92553,
    pattern=(A(kind="attn", attn="gqa"),),
    frontend="vision_patches", n_patches=256,
)

# --- 8 experts top-2 [hf:xai-org/grok-1; unverified] -------------------------
GROK1_314B = ModelConfig(
    name="grok-1-314b", d_model=6144, n_layers=64, n_heads=48,
    n_kv_heads=8, d_ff=32768, vocab=131072,
    pattern=(A(kind="attn", attn="gqa", mlp="moe"),),
    n_experts=8, top_k=2,
    opt_dtype="bfloat16",
)

# --- 8 experts top-2, SWA [arXiv:2401.04088; hf] -----------------------------
MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b", d_model=4096, n_layers=32, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab=32000,
    pattern=(A(kind="attn", attn="gqa", mlp="moe", window=4096),),
    n_experts=8, top_k=2,
    subquadratic=True,  # SWA: cache capped at window
    opt_dtype="bfloat16",
)

REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        MUSICGEN_LARGE, JAMBA_52B, MAMBA2_780M, MINICPM3_4B, QWEN25_14B,
        MISTRAL_LARGE_123B, QWEN15_110B, INTERNVL2_2B, GROK1_314B,
        MIXTRAL_8X7B,
    ]
}


def get(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
