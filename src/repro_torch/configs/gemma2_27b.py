"""gemma2-27b [dense]: 46L, d_model=4608, 32H GQA kv=16, head_dim=128,
d_ff=36864, vocab=256000 (arXiv:2408.00118).  Alternating local(4096)/global
attention, attn-logit softcap 50, final-logit softcap 30, sandwich norms,
query scale 1/sqrt(d_model/n_heads)=1/12."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="gemma2-27b",
        family="dense",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab_size=256000,
        superblock=(LayerSpec(kind="attn", mlp="glu", sliding_window=4096),
                    LayerSpec(kind="attn", mlp="glu")),
        n_repeat=23,
        attn_softcap=50.0,
        final_softcap=30.0,
        sandwich_norm=True,
        embed_scale=True,
        attn_scale=(4608 / 32) ** -0.5,
        rope_theta=10000.0,
        microbatch=16,
        accum_dtype="bfloat16",  # multi-pod HBM fit (§Dry-run)
    )
