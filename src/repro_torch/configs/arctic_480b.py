"""arctic-480b [moe]: 35L, d_model=7168, 56H GQA kv=8, vocab=32000
(hf:Snowflake/snowflake-arctic-base).  128 experts top-2 (d_ff=4864) with a
dense residual MLP in parallel (dense-MoE hybrid).

Optimizer defaults to Adafactor: 480B params with unfactored AdamW fp32
moments does not fit 256 x 16 GB (see DESIGN.md §Arch-applicability)."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        superblock=(LayerSpec(kind="attn", mlp="moe"),),
        n_repeat=35,
        n_experts=128,
        top_k=2,
        d_ff_expert=4864,
        moe_dense_residual=True,
        optimizer="adafactor",
        rope_theta=10000.0,
        tie_embeddings=False,
        microbatch=16,
        # §Perf hillclimb B (EXPERIMENTS.md): bf16 grad accumulation +
        # capacity 1.0 (compute -19%, fit -3.3GB).  remat="dots" gives a
        # further -10% memory-term / -11% compute when HBM allows.
        accum_dtype="bfloat16",
        capacity_factor=1.0,
    )
