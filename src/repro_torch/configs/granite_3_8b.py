"""granite-3-8b [dense]: 40L, d_model=4096, 32H GQA kv=8, d_ff=12800,
vocab=49155 (hf:ibm-granite/granite-3.0-8b-base family)."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab_size=49155,
        superblock=(LayerSpec(kind="attn", mlp="glu"),),
        n_repeat=40,
        rope_theta=10000.0,
        microbatch=8,
    )
