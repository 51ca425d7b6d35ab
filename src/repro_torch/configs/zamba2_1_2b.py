"""zamba2-1.2b [hybrid]: 38L Mamba2 backbone + shared-weight attention blocks
interleaved (arXiv:2411.15242).  d_model=2048, 32H MHA (kv=32) in the shared
block, d_ff=8192 (shared block MLP), vocab=32000, ssm_state=64.

Layout: 3 unscanned mamba layers, then 5 repeats of
(shared_attn + 6 mamba) = 38 plan entries, shared attention applied 5x with
ONE weight set (zamba2's signature weight sharing; input = concat(hidden,
initial embeddings) as in the paper).  Decode uses a 4096-token rolling
window on the shared attention -> O(1)-ish state at 500k context (this is
why zamba2 runs the long_500k shape; see DESIGN.md)."""
from repro_torch.configs.base import LayerSpec, ModelConfig

M = LayerSpec(kind="mamba2", mlp="none")


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        prologue=(M, M, M),
        superblock=(LayerSpec(kind="shared_attn", mlp="none"), M, M, M, M, M, M),
        n_repeat=5,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        decode_window=4096,
        rope_theta=10000.0,
        microbatch=16,
    )
