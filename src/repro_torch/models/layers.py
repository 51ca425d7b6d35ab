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

Under a mesh (DTensor parameters and activations) every projection is
``sharding.linear``: column-parallel into heads split over ``model``
(``unflatten_heads``), row-parallel out of them with the partial sums
reduced; caches placed over ``kv_seq`` or heads are written on each
rank's own block (``write_at``).
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.parallel.sharding import (flatten_heads, linear, local_offset,
                                           on_local_shards, rows, run_local,
                                           unflatten_heads)

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
    A DTensor ``x`` is rotated on its local rows and heads (the angles are
    a plain tensor, which DTensor does not mix with a sharded one)."""
    return on_local_shards(lambda x: _rope(x, positions, theta), x, keep=-2)


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
    h = linear(x, p.wi.to(cdtype))
    g = linear(x, p.wg.to(cdtype))
    return linear(act(g) * h, p.wo.to(cdtype))


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
    h = linear(x, p.wi.to(cdtype))
    return linear(F.gelu(h, approximate="tanh"), p.wo.to(cdtype))


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
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    q, k, v = qkv(p, xc, cfg, positions)
    out = kops.flash_attention(
        q, k, v, causal=spec.causal, scale=attention_scale(cfg),
        softcap_val=cfg.attn_softcap, window=spec.sliding_window, q_pos0=0,
        use_pallas=cfg.use_pallas)
    o = linear(flatten_heads(out), p.wo.to(cdt))
    if return_kv:
        return o.to(x.dtype), k, v
    return o.to(x.dtype), None


def qkv(p, xc, cfg: ModelConfig, positions):
    """q (B,S,H,Dh), k and v (B,S,KV,Dh) of ``xc`` in the compute dtype,
    q and k normed (``qk_norm``) and roped.  Under a mesh the projections
    are column-parallel: the heads come out split over ``model`` where
    they divide it, else DTensor gathers the columns."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    cdt = xc.dtype
    q = unflatten_heads(linear(xc, p.wq.to(cdt)), H)
    k = unflatten_heads(linear(xc, p.wk.to(cdt)), KV)
    v = unflatten_heads(linear(xc, p.wv.to(cdt)), KV)
    if cfg.qk_norm:
        q = rmsnorm(p.qnorm, q, cfg.norm_eps)
        k = rmsnorm(p.knorm, k, cfg.norm_eps)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


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
    first, as the reference's weakly typed scalar is (on each rank's
    shard of a DTensor)."""
    if x.dtype == torch.int8 and isinstance(x, DTensor):
        return run_local(lambda t: cache_load(t, cdt), x)
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
    space.  Under a mesh the heads are split over ``model`` (column-parallel
    wq, wk_b, wv_b; row-parallel wo); the latent is read whole, and a
    decode gathers the cached latent over ``kv_seq``.  Returns (out,
    cache)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dr = cfg.qk_rope_dim
    dn, dv = cfg.qk_nope_dim, cfg.v_head_dim
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    q = unflatten_heads(linear(xc, p.wq.to(cdt)), H)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    latent = rmsnorm(p.kv_norm, rows(linear(xc, p.wkv_a.to(cdt))),
                     cfg.norm_eps)
    k_rope = rope(linear(xc, p.wk_rope.to(cdt))[:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0, :]  # (B,S,dr) shared across heads

    scale = 1.0 / math.sqrt(dn + dr)
    new_cache = None
    if cache is not None:
        cl, cr = cache["latent"], cache["k_rope"]
        start = max(0, min(cache_pos, cl.shape[1] - S))
        write_at(cl, start, cache_store(latent, cl.dtype))
        write_at(cr, start, cache_store(k_rope, cr.dtype))
        new_cache = {"latent": cl, "k_rope": cr}
        if S == 1:
            wkb, wvb = p.wk_b.to(cdt), p.wv_b.to(cdt)
            if isinstance(q_nope, DTensor):  # the heads q holds, whole rows
                q_nope = q_nope.redistribute(q_nope.device_mesh, [
                    pl if pl in (Shard(0), Shard(2)) else Replicate()
                    for pl in q_nope.placements])
                q_rope = q_rope.redistribute(q_nope.device_mesh,
                                             q_nope.placements)
                heads = [Shard(1) if pl == Shard(2) else Replicate()
                         for pl in q_nope.placements]
                wkb = wkb.redistribute(wkb.device_mesh, heads)
                wvb = wvb.redistribute(wvb.device_mesh, heads)
            out = run_local(partial(_mla_decode, cfg=cfg, cache_pos=cache_pos,
                                    scale=scale),
                            q_nope, q_rope, rows(cache_load(cl, cdt)),
                            rows(cache_load(cr, cdt)), wkb, wvb)
            o = linear(flatten_heads(out), p.wo.to(cdt))
            return o.to(x.dtype), new_cache

    # train / prefill: rebuild full K, V and run flash attention
    k_nope = unflatten_heads(linear(latent, p.wk_b.to(cdt)), H)
    vv = unflatten_heads(linear(latent, p.wv_b.to(cdt)), H)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)], -1)
    q_full = torch.cat([q_nope, q_rope], -1)
    # pad v to the qk dim for the one kernel, then slice (dv <= dn + dr)
    v_pad = torch.cat([vv, torch.zeros_like(vv[..., :dn + dr - dv])], -1)
    out = kops.flash_attention(q_full, k_full, v_pad, causal=spec.causal,
                               scale=scale, use_pallas=cfg.use_pallas)[..., :dv]
    o = linear(flatten_heads(out), p.wo.to(cdt))
    return o.to(x.dtype), new_cache


def _mla_decode(q_nope, q_rope, lat, kr, wkb, wvb, *, cfg, cache_pos, scale):
    """One-token MLA attention of the local heads over the whole latent
    cache (lat (B,T,r), kr (B,T,dr) in the compute dtype); wkb / wvb hold
    the local heads' columns.  -> (B,1,H_local,dv)."""
    B, _, H, dn = q_nope.shape
    r, dv = lat.shape[-1], cfg.v_head_dim
    T = lat.shape[1]
    mask = (torch.arange(T, device=lat.device) <= cache_pos)[None, None, :]
    if cfg.mla_absorb:
        # absorb wk_b into q: q_lat (B,1,H,r) = q_nope @ wk_b^T per head
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, wkb.reshape(r, H, dn))
        logits = torch.einsum("bshr,btr->bhst", q_lat, lat)
        logits += torch.einsum("bshr,btr->bhst", q_rope, kr)
        logits = (logits * scale)[:, :, 0, :]  # (B,H,T)
        logits = torch.where(mask, logits, -1e30)
        w = torch.softmax(logits.float(), dim=-1).to(lat.dtype)
        ctx_lat = torch.einsum("bht,btr->bhr", w, lat)
        out = torch.einsum("bhr,rhv->bhv", ctx_lat, wvb.reshape(r, H, dv))
        return out[:, None]
    k_nope = (lat @ wkb).reshape(B, T, H, dn)
    vv = (lat @ wvb).reshape(B, T, H, dv)
    logits = torch.einsum("bshn,bthn->bhst", q_nope, k_nope)
    logits += torch.einsum("bshr,btr->bhst", q_rope, kr)
    logits = (logits * scale)[:, :, 0, :]
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits.float(), dim=-1).to(lat.dtype)
    return torch.einsum("bht,bthv->bhv", w, vv)[:, None]


def write_at(buf, start, value):
    """``buf[:, start:start + value.shape[1]] = value``, in place.  A
    DTensor ``buf`` (a cache placed over ``kv_seq`` or heads) is written on
    each rank's own block: ``value`` is first placed as ``buf`` is, whole
    along dim 1, and each rank copies the positions it holds."""
    if not isinstance(buf, DTensor):
        buf[:, start:start + value.shape[1]] = value
        return
    mesh = buf.device_mesh
    val = value.redistribute(mesh, [Replicate() if pl == Shard(1) else pl
                                    for pl in buf.placements]).to_local()
    lo, n = local_offset(buf, 1)
    a, b = max(start, lo), min(start + val.shape[1], lo + n)
    if a < b:
        buf.to_local()[:, a - lo:b - lo] = val[:, a - start:b - start]


def init_mla_cache(cfg: ModelConfig, batch, max_len, dtype, device):
    return {
        "latent": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                              device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
    }
