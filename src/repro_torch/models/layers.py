"""Core neural layers (port of ``repro/models/layers.py``): norms, RoPE, the
GLU and GELU MLPs, GQA attention (with the reference's ``d_in``), the int8
cache helpers and MLA (DeepSeek multi-head latent attention).  The
reference's ``attention`` also takes ``kv_x`` / ``rope_on``, which none of
its callers sets; cross-attention is ``models/lm.py``'s ``_cross_attn``.

Parameters live in ``nn.Module``s whose attribute names are the reference's
dict keys (``p.wq`` for ``p["wq"]``); the math is plain functions on
tensors, as in the reference.  Public layouts are the reference's:
activations (B, S, D), heads (B, S, H, Dh).  Attention's inner
softmax(QK^T)V runs through :mod:`repro_torch.kernels.ops`, which launches
the CUDA flash kernel for CUDA tensors; MLA's prefill does too, at head dim
qk_nope + qk_rope (192 for deepseek-v2-lite) with V zero-padded to it, and
its decode is the reference's plain einsums (the reference has no Pallas
decode either).
"""
from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.parallel.sharding import on_local_shards

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
    """Apply rotary embeddings.  x: (..., S, H, D); positions: (..., S).
    A DTensor ``x`` is rotated on its local rows (the angles are a plain
    tensor, which DTensor does not mix with a sharded one)."""
    return on_local_shards(lambda x: _rope(x, positions, theta), x)


def _rope(x, positions, theta):
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


class GELUMLP(nn.Module):
    def __init__(self, gen, d_model, d_ff, dtype, device):
        super().__init__()
        self.wi = dense_init(gen, (d_model, d_ff), d_model, dtype, device)
        self.wo = dense_init(gen, (d_ff, d_model), d_ff, dtype, device)


def init_gelu_mlp(gen, d_model, d_ff, dtype, device) -> GELUMLP:
    return GELUMLP(gen, d_model, d_ff, dtype, device)


def gelu_mlp(p, x, cdtype):
    # jax.nn.gelu's default is the tanh form; the exact erf form differs by
    # about 1e-3
    h = x @ p.wi.to(cdtype)
    return F.gelu(h, approximate="tanh") @ p.wo.to(cdtype)


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

    x: (B, S, D).  Cache handling (decode / rolling windows) and
    cross-attention live in models/lm.py.
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


# ---------------------------------------------------------------------------
# quantized-cache helpers (int8 serving caches)
# ---------------------------------------------------------------------------

CACHE_QSCALE = 40.0  # static scale: post-RMSNorm latents / roped keys ~ O(1)


def cache_store(x, dtype):
    """``x`` as the cache's dtype; int8 is round(x * 40) clipped to +-127
    (``torch.round`` rounds half to even, as ``jnp.round``)."""
    if dtype == torch.int8:
        return torch.clamp(torch.round(x.float() * CACHE_QSCALE),
                           -127, 127).to(torch.int8)
    return x.to(dtype)


def cache_load(x, cdt):
    """The cache in the compute dtype; int8 times 1/40 rounded to ``cdt``
    first, as the reference's weakly typed scalar is."""
    if x.dtype == torch.int8:
        return x.to(cdt) * torch.tensor(1.0 / CACHE_QSCALE, dtype=cdt,
                                        device=x.device)
    return x.to(cdt)


# ---------------------------------------------------------------------------
# MLA -- DeepSeek-V2 multi-head latent attention
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
        dn, dv = cfg.qk_nope_dim, cfg.v_head_dim
        dt = dtype_of(cfg.param_dtype)
        self.wq = dense_init(gen, (d, H * (dn + dr)), d, dt, device)
        self.wkv_a = dense_init(gen, (d, r), d, dt, device)  # latent down-proj
        self.wk_rope = dense_init(gen, (d, dr), d, dt, device)  # shared rope key
        self.kv_norm = init_rmsnorm(r, dt, device)
        self.wk_b = dense_init(gen, (r, H * dn), r, dt, device)  # latent -> k_nope
        self.wv_b = dense_init(gen, (r, H * dv), r, dt, device)  # latent -> v
        self.wo = dense_init(gen, (H * dv, d), H * dv, dt, device)


def init_mla(gen, cfg: ModelConfig, device) -> MLA:
    return MLA(gen, cfg, device)


def mla_attention(p, x, cfg: ModelConfig, spec: LayerSpec, *, positions,
                  cache=None, cache_pos=None):
    """MLA: queries per head (nope + rope); K/V rebuilt from a shared latent
    of rank ``kv_lora_rank``; the cache holds only the latent and the rope
    key.  With a cache the new rows are written in place at ``cache_pos``
    (clamped as ``dynamic_update_slice`` clamps); a prefill then attends
    within its own chunk, as the reference does.  One-token decode with
    ``cfg.mla_absorb`` folds wk_b into the query and attends in the latent
    space.  Returns (out, cache)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    dn, dv = cfg.qk_nope_dim, cfg.v_head_dim
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    q = (xc @ p.wq.to(cdt)).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    latent = rmsnorm(p.kv_norm, xc @ p.wkv_a.to(cdt), cfg.norm_eps)
    k_rope = rope((xc @ p.wk_rope.to(cdt))[:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0, :]  # (B,S,dr) shared across heads

    scale = 1.0 / math.sqrt(dn + dr)
    new_cache = None
    if cache is not None:
        cl, cr = cache["latent"], cache["k_rope"]
        start = max(0, min(cache_pos, cl.shape[1] - S))
        cl[:, start:start + S] = cache_store(latent, cl.dtype)
        cr[:, start:start + S] = cache_store(k_rope, cr.dtype)
        new_cache = {"latent": cl, "k_rope": cr}
        if S == 1:
            T = cl.shape[1]
            mask = (torch.arange(T, device=x.device) <= cache_pos)[None, None, :]
            lat, kr = cache_load(cl, cdt), cache_load(cr, cdt)
            if cfg.mla_absorb:
                # absorb wk_b into q: q_lat (B,1,H,r) = q_nope @ wk_b^T per head
                wkb = p.wk_b.to(cdt).reshape(r, H, dn)
                q_lat = torch.einsum("bshn,rhn->bshr", q_nope, wkb)
                logits = torch.einsum("bshr,btr->bhst", q_lat, lat)
                logits += torch.einsum("bshr,btr->bhst", q_rope, kr)
                logits = (logits * scale)[:, :, 0, :]  # (B,H,T)
                logits = torch.where(mask, logits, -1e30)
                w = torch.softmax(logits.float(), dim=-1).to(cdt)
                ctx_lat = torch.einsum("bht,btr->bhr", w, lat)
                wvb = p.wv_b.to(cdt).reshape(r, H, dv)
                out = torch.einsum("bhr,rhv->bhv", ctx_lat, wvb)[:, None]
            else:
                k_nope = (lat @ p.wk_b.to(cdt)).reshape(B, T, H, dn)
                vv = (lat @ p.wv_b.to(cdt)).reshape(B, T, H, dv)
                logits = torch.einsum("bshn,bthn->bhst", q_nope, k_nope)
                logits += torch.einsum("bshr,btr->bhst", q_rope, kr)
                logits = (logits * scale)[:, :, 0, :]
                logits = torch.where(mask, logits, -1e30)
                w = torch.softmax(logits.float(), dim=-1).to(cdt)
                out = torch.einsum("bht,bthv->bhv", w, vv)[:, None]
            o = out.reshape(B, 1, H * dv) @ p.wo.to(cdt)
            return o.to(x.dtype), new_cache

    # train / prefill: rebuild full K, V and run flash attention
    k_nope = (latent @ p.wk_b.to(cdt)).reshape(B, S, H, dn)
    vv = (latent @ p.wv_b.to(cdt)).reshape(B, S, H, dv)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)], -1)
    q_full = torch.cat([q_nope, q_rope], -1)
    # pad v to the qk dim for the one kernel, then slice (dv <= dn + dr)
    v_pad = F.pad(vv, (0, dn + dr - dv))
    out = kops.flash_attention(q_full, k_full, v_pad, causal=spec.causal,
                               scale=scale, use_pallas=cfg.use_pallas)[..., :dv]
    o = out.reshape(B, S, H * dv) @ p.wo.to(cdt)
    return o.to(x.dtype), new_cache


def init_mla_cache(cfg: ModelConfig, batch, max_len, dtype, device):
    return {
        "latent": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                              device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
    }
