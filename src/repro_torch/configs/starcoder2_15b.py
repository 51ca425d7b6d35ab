"""starcoder2-15b [dense]: 40L, d_model=6144, 48H GQA kv=4, d_ff=24576,
vocab=49152; GQA + RoPE (arXiv:2402.19173).  MLP is a plain GELU stack (the
published config), not gated."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        superblock=(LayerSpec(kind="attn", mlp="gelu_mlp"),),
        n_repeat=40,
        rope_theta=100000.0,
        tie_embeddings=False,
        microbatch=16,
    )
