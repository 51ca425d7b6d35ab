"""Architecture registry of the port: ``--arch <id>`` resolution, reduced
configs for CPU tests, per-arch sharding-rule overrides
(``parallel/sharding.py``) and input specs for every workload shape.
``ARCHS`` holds the reference's eleven architectures."""
from __future__ import annotations

import importlib
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                     shape_applicable)

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

# per-arch logical->physical rule overrides (see parallel/sharding.py)
ARCH_RULES: Dict[str, Dict] = {
    # whisper-tiny is far too small for tensor parallelism on 256 chips:
    # run it pure-DP with batch over every mesh axis.
    "whisper-tiny": {"batch": ("pod", "data", "model"), "fsdp": (),
                     "tensor": (), "vocab": (), "heads": ()},
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    cfg = importlib.import_module(ARCHS[arch_id]).get_config()
    cfg.validate()
    return cfg


def arch_rules(arch_id: str) -> Optional[Dict]:
    return ARCH_RULES.get(arch_id)


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


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def _extras(cfg: ModelConfig, B: int):
    ex = {}
    if cfg.n_enc_layers:
        ex["enc_embed"] = ((B, cfg.enc_len, cfg.d_model), torch.bfloat16)
    if cfg.n_img_tokens:
        ex["img_embed"] = ((B, cfg.n_img_tokens, cfg.d_vision), torch.bfloat16)
    return ex


def input_specs(cfg: ModelConfig, shape: ShapeConfig, abstract: bool = True,
                gen: Optional[torch.Generator] = None, device="cpu"):
    """Model inputs for a workload shape.

    ``abstract=True`` -> tensors on the meta device (the dry run's
    stand-ins, no allocation); ``abstract=False`` -> concrete random
    tensors from ``gen`` (a seeded CPU generator by default) on
    ``device``: integer tokens uniform over the vocabulary, extras
    normal x 0.02 in bf16.

    train/prefill: {"tokens", ("labels")} (+ stub-frontend embeddings).
    decode: {"token": (B,1)}; the caches are a separate argument built by
    ``models.lm.init_caches`` (see launch/dryrun.py).
    """
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    if shape.kind == "train":
        specs["tokens"] = ((B, S), torch.int32)
        specs["labels"] = ((B, S), torch.int32)
    elif shape.kind == "prefill":
        specs["tokens"] = ((B, S), torch.int32)
    else:  # decode
        specs["token"] = ((B, 1), torch.int32)
    if shape.kind != "decode":
        specs.update(_extras(cfg, B))

    if abstract:
        return {k: torch.empty(s, dtype=d, device="meta")
                for k, (s, d) in specs.items()}
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    out = {}
    for k, (s, d) in specs.items():
        if d == torch.int32:
            t = torch.randint(0, cfg.vocab_size, s, generator=gen, dtype=d)
        else:
            t = (torch.randn(s, generator=gen) * 0.02).to(d)
        out[k] = t.to(device)
    return out


def applicable_shapes(arch_id: str):
    cfg = get_config(arch_id)
    return [s for s in SHAPES.values()
            if shape_applicable(arch_id, s.name, cfg.family)]
