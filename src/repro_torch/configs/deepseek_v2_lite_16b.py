"""deepseek-v2-lite-16b [moe]: 27L, d_model=2048, 16H, vocab=102400
(arXiv:2405.04434).  MLA with kv_lora_rank=512 (+64 decoupled rope dims,
128 nope, 128 v); MoE: 64 routed experts top-6 + 2 shared experts,
d_ff(expert)=1408; first layer is dense (d_ff=10944, published config —
the assignment line lists only the expert d_ff).

The assignment note "2 shared+160 routed" matches full V2; the -Lite config
(64 routed) is used, consistent with the "MoE 64e top-6" header."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=10944,
        vocab_size=102400,
        prologue=(LayerSpec(kind="mla", mlp="glu"),),
        superblock=(LayerSpec(kind="mla", mlp="moe"),),
        n_repeat=26,
        kv_lora_rank=512,
        qk_rope_dim=64,
        qk_nope_dim=128,
        v_head_dim=128,
        n_experts=64,
        top_k=6,
        n_shared_experts=2,
        d_ff_expert=1408,
        rope_theta=10000.0,
        microbatch=8,
        # §Perf hillclimb C (EXPERIMENTS.md): latent-space decode via k-up
        # projection absorption — 70-90x HLO-flop cut at decode; pair with
        # int8 latent cache (ServeEngine cache_dtype / dryrun --cache-dtype)
        # for a further -34% on the decode memory term.
        mla_absorb=True,
    )
