"""llama-3.2-vision-11b [vlm]: 40L total = 32 self-attn + 8 gated cross-attn
image layers (every 5th), d_model=4096, 32H GQA kv=8, d_ff=14336,
vocab=128256 (hf:meta-llama/Llama-3.2-11B-Vision).  The vision tower is a
STUB: input_specs() provides precomputed patch embeddings (B, 1600, 4096)
which w_img projects into the text space; cross-attn K/V over them are
cached once at prefill."""
from repro_torch.configs.base import LayerSpec, ModelConfig

A = LayerSpec(kind="attn", mlp="glu")


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        superblock=(LayerSpec(kind="xattn", mlp="glu"), A, A, A, A),
        n_repeat=8,
        n_img_tokens=1600,
        d_vision=4096,
        rope_theta=500000.0,
        microbatch=8,
    )
