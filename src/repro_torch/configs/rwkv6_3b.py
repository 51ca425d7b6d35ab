"""rwkv6-3b "Finch" [ssm]: 32L, d_model=2560 (attn-free), d_ff=8960,
vocab=65536; data-dependent decay linear attention (arXiv:2404.05892).
40 wkv heads of dim 64; O(1) decode state -> runs the long_500k shape."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        head_dim=64,
        d_ff=8960,
        vocab_size=65536,
        superblock=(LayerSpec(kind="rwkv6", mlp="none"),),
        n_repeat=32,
        rwkv_head_dim=64,
        microbatch=8,
        # §Perf-optimized defaults (EXPERIMENTS.md hillclimb A): blocked WKV
        # at chunk 64 cuts the dominant memory-roofline term 1.87x vs the
        # naive chunked form at 256.  Paper-faithful baseline: override
        # {"ssm_chunk": 256, "wkv_impl": "chunked"}.
        ssm_chunk=64,
        wkv_impl="blocked",
        wkv_subchunk=16,
    )
