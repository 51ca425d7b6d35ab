"""Model/workload configuration dataclasses.

The port's own copy of ``repro/configs/base.py`` (the port imports nothing of
``repro``).  Field names and defaults are kept identical, ``use_pallas``
included, so a port config and a reference config compare field for field.

Every architecture is a ``ModelConfig`` built from a repeating ``superblock``
of ``LayerSpec``s (repeated ``n_repeat`` times), plus optional prologue layers
and an optional encoder stack.  The port runs the plan as a loop over layers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

# ---------------------------------------------------------------------------
# Layer / model configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside a superblock."""

    kind: str = "attn"  # attn | mla | mamba2 | rwkv6 | xattn
    mlp: str = "glu"  # glu | gelu_mlp | moe | none (rwkv6 has its own)
    # attention options
    sliding_window: Optional[int] = None  # local attention window (gemma2)
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str = ""
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm
    # core dims
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    # layer plan
    superblock: Tuple[LayerSpec, ...] = (LayerSpec(),)
    n_repeat: int = 2  # superblock repeats; n_repeat*len(superblock)+prologue = n_layers
    prologue: Tuple[LayerSpec, ...] = ()  # unscanned leading layers
    # attention options
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    final_softcap: Optional[float] = None  # gemma2: 30.0
    qk_norm: bool = False
    attn_scale: Optional[float] = None  # override 1/sqrt(head_dim)
    # MLA (deepseek) options
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # MoE options
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_dense_residual: bool = False  # arctic: dense MLP in parallel w/ MoE
    router_noise: float = 0.0
    capacity_factor: float = 1.25
    moe_impl: str = "gshard"  # gshard | sort (sort = beyond-paper optimized)
    moe_group: int = 1024  # tokens per dispatch group (capacity granularity)
    # Mamba2 / SSM options
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    shared_attn_every: int = 0  # zamba2: shared-weight attn block period
    # RWKV6 options
    rwkv_head_dim: int = 64
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32
    wkv_impl: str = "chunked"  # chunked | blocked (§Perf optimized)
    wkv_subchunk: int = 16
    # encoder (whisper) / vision options
    n_enc_layers: int = 0
    enc_len: int = 1500  # precomputed frame embeddings (stub frontend)
    n_img_tokens: int = 0  # precomputed patch embeddings (stub frontend)
    d_vision: int = 0
    xattn_every: int = 0  # vision: cross-attn layer period inside superblock plan
    # embeddings
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma-style sqrt(d_model) scaling
    sandwich_norm: bool = False  # gemma2: pre+post norms around attn/mlp
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # training
    optimizer: str = "adamw"  # adamw | adafactor
    remat: str = "full"  # none | full | dots
    microbatch: int = 1  # gradient-accumulation microbatches per step
    accum_dtype: str = "float32"  # grad-accumulator dtype (bf16: §Perf lever)
    # serving
    decode_window: Optional[int] = None  # cap KV length at decode (hybrid archs)
    mla_absorb: bool = False  # deepseek decode matmul-absorption (beyond-paper)
    # kernels
    use_pallas: str = "auto"  # auto | never | interpret
    # lowering: unroll layer scans (dry-run flop probes need straight-line
    # HLO because XLA cost_analysis counts a while-loop body exactly once)
    scan_unroll: Any = 1  # int | True

    @property
    def plan(self) -> Tuple[LayerSpec, ...]:
        return self.prologue + self.superblock * self.n_repeat

    def validate(self) -> None:
        n = len(self.prologue) + len(self.superblock) * self.n_repeat
        assert n == self.n_layers, (
            f"{self.arch_id}: layer plan covers {n} layers, config says {self.n_layers}")
        if any(s.kind == "attn" for s in self.plan):
            assert self.n_heads % self.n_kv_heads == 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Workload shapes (assigned input-shape sets)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# archs with a sub-quadratic long-context path
SUBQUADRATIC = {"zamba2-1.2b", "rwkv6-3b"}


def shape_applicable(arch_id: str, shape: str, family: str) -> bool:
    if shape == "long_500k":
        return arch_id in SUBQUADRATIC
    return True
