"""whisper-tiny [audio]: enc-dec, 4L encoder + 4L decoder, d_model=384, 6H,
d_ff=1536, vocab=51865 (arXiv:2212.04356).  The conv/audio frontend is a
STUB per the assignment: input_specs() provides precomputed frame embeddings
(B, 1500, 384).  Decoder layers are (self-attn + cross-attn + GELU MLP).

Tiny model on a 256-chip mesh: the per-arch sharding rules map `batch` to
all mesh axes (pure data parallelism) — see registry.ARCH_RULES."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-tiny",
        family="audio",
        n_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51865,
        superblock=(LayerSpec(kind="dec", mlp="gelu_mlp"),),
        n_repeat=4,
        n_enc_layers=4,
        enc_len=1500,
        rope_theta=10000.0,
        # 51865-vocab logits replicate over `model` (odd vocab): microbatch
        # to keep the fp32 softmax working set inside HBM (§Dry-run fit)
        microbatch=8,
    )
