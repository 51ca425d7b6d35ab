"""Core neural layers (port of ``repro/models/layers.py``, dense subset):
norms, RoPE, the GLU MLP and GQA attention (with the reference's ``d_in``).

Parameters live in ``nn.Module``s whose attribute names are the reference's
dict keys (``p.wq`` for ``p["wq"]``); the math is plain functions on
tensors, as in the reference.  Public layouts are the reference's:
activations (B, S, D), heads (B, S, H, Dh).  Attention's inner
softmax(QK^T)V runs through :mod:`repro_torch.kernels.ops`, which launches
the CUDA flash kernel for CUDA tensors.
"""
from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops as kops

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen, shape, in_axis_size, dtype, device):
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    w = torch.randn(shape, generator=gen, device=device) * scale
    return nn.Parameter(w.to(dtype))


def embed_init(gen, shape, dtype, device):
    w = torch.randn(shape, generator=gen, device=device) * 0.02
    return nn.Parameter(w.to(dtype))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))


def init_rmsnorm(d, dtype, device) -> RMSNorm:
    return RMSNorm(d, dtype, device)


def rmsnorm(p, x, eps):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p.scale.float())).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, theta):
    """Apply rotary embeddings.  x: (..., S, H, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * (
        torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., :, None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


def softcap(x, cap):
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class GLUMLP(nn.Module):
    def __init__(self, gen, d_model, d_ff, dtype, device):
        super().__init__()
        self.wi = dense_init(gen, (d_model, d_ff), d_model, dtype, device)
        self.wg = dense_init(gen, (d_model, d_ff), d_model, dtype, device)
        self.wo = dense_init(gen, (d_ff, d_model), d_ff, dtype, device)


def init_glu_mlp(gen, d_model, d_ff, dtype, device) -> GLUMLP:
    return GLUMLP(gen, d_model, d_ff, dtype, device)


def glu_mlp(p, x, cdtype, act=F.silu):
    h = x @ p.wi.to(cdtype)
    g = x @ p.wg.to(cdtype)
    return (act(g) * h) @ p.wo.to(cdtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, gen, cfg: ModelConfig, device, d_in=None):
        super().__init__()
        d = d_in or cfg.d_model
        H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = dtype_of(cfg.param_dtype)
        self.wq = dense_init(gen, (d, H * Dh), d, dt, device)
        self.wk = dense_init(gen, (d, KV * Dh), d, dt, device)
        self.wv = dense_init(gen, (d, KV * Dh), d, dt, device)
        self.wo = dense_init(gen, (H * Dh, cfg.d_model), H * Dh, dt, device)
        if cfg.qk_norm:
            self.qnorm = init_rmsnorm(Dh, dt, device)
            self.knorm = init_rmsnorm(Dh, dt, device)


def init_attention(gen, cfg: ModelConfig, device, d_in=None) -> Attention:
    """``d_in`` is the input width (zamba2's shared block takes 2·d_model)."""
    return Attention(gen, cfg, device, d_in)


def attention_scale(cfg: ModelConfig) -> float:
    if cfg.attn_scale is not None:
        return cfg.attn_scale
    return 1.0 / math.sqrt(cfg.head_dim)


def attention(p, x, cfg: ModelConfig, spec: LayerSpec, *, positions,
              return_kv: bool = False):
    """GQA self-attention over a full sequence (train / prefill).

    x: (B, S, D).  Cache handling (decode / rolling windows) lives in
    models/lm.py; cross-attention comes with the encoder slice.
    """
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    q = (xc @ p.wq.to(cdt)).reshape(B, S, H, Dh)
    k = (xc @ p.wk.to(cdt)).reshape(B, S, KV, Dh)
    v = (xc @ p.wv.to(cdt)).reshape(B, S, KV, Dh)
    if cfg.qk_norm:
        q = rmsnorm(p.qnorm, q, cfg.norm_eps)
        k = rmsnorm(p.knorm, k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    out = kops.flash_attention(
        q, k, v, causal=spec.causal, scale=attention_scale(cfg),
        softcap_val=cfg.attn_softcap, window=spec.sliding_window, q_pos0=0,
        use_pallas=cfg.use_pallas)
    out = out.reshape(B, S, H * Dh)
    o = out @ p.wo.to(cdt)
    if return_kv:
        return o.to(x.dtype), k, v
    return o.to(x.dtype), None


def init_attn_cache(cfg: ModelConfig, batch, max_len, dtype, device):
    Dh, KV = cfg.head_dim, cfg.n_kv_heads
    return {
        "k": torch.zeros((batch, max_len, KV, Dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, KV, Dh), dtype=dtype, device=device),
    }
