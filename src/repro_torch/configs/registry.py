"""Architecture registry of the port: ``--arch <id>`` resolution and reduced
configs for CPU tests.  ``ARCHS`` holds the reference's eleven
architectures."""
from __future__ import annotations

import importlib
import math
from typing import Any, Dict

from repro_torch.configs.base import ModelConfig

ARCHS = {
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "jag-surrogate": "repro_torch.configs.jag_surrogate",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    cfg = importlib.import_module(ARCHS[arch_id]).get_config()
    cfg.validate()
    return cfg


def reduced_config(arch_id: str) -> ModelConfig:
    """Same family/topology, tiny dims: one forward must run on CPU."""
    cfg = get_config(arch_id)
    heads = max(2, cfg.n_heads // 8)
    kv = math.gcd(heads, max(1, min(cfg.n_kv_heads, heads)))
    over: Dict[str, Any] = dict(
        d_model=128, n_heads=heads, n_kv_heads=kv, head_dim=32,
        d_ff=256, vocab_size=512, n_repeat=2, microbatch=1,
        ssm_state=16, ssm_head_dim=32, ssm_chunk=32,
        rwkv_head_dim=32, rwkv_lora_decay=16, rwkv_lora_mix=8,
        kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        enc_len=16 if cfg.n_enc_layers else cfg.enc_len,
        n_img_tokens=16 if cfg.n_img_tokens else 0,
        d_vision=64 if cfg.n_img_tokens else 0,
        decode_window=32 if cfg.decode_window else None,
        attn_scale=None,
    )
    over["n_layers"] = len(cfg.prologue) + len(cfg.superblock) * over["n_repeat"]
    r = cfg.replace(**over)
    r.validate()
    return r
