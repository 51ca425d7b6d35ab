"""phi4-mini-3.8b [dense]: 32L, d_model=3072, 24H GQA kv=8, d_ff=8192,
vocab=200064; RoPE + SwiGLU + GQA (arXiv:2412.08905).

Note: 24 heads / 8 kv-heads do not divide the 16-way `model` mesh axis; the
divisibility-aware sharding rules fall back to replicated head axes with the
flat QKV projections still tensor-sharded (see parallel/sharding.py)."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="phi4-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=200064,
        superblock=(LayerSpec(kind="attn", mlp="glu"),),
        n_repeat=32,
        rope_theta=10000.0,
        microbatch=8,
    )
