"""Language-model stack (port of ``repro/models/lm.py``).

A model is the reference's layer plan (``cfg.plan``: prologue, then the
superblock ``n_repeat`` times) held as an ``nn.ModuleList``; the reference's
``lax.scan`` over stacked blocks is a loop over layers here.  The port runs
the layer kinds ``attn`` (with the ``glu`` MLP), ``rwkv6``, ``mamba2`` and
``shared_attn`` (zamba2's shared-weight block, whose parameters live once at
the top of ``LM`` and whose input is concat(hidden, embeddings of the current
call)); every other kind or option raises ``NotImplementedError`` naming the
ROADMAP item that brings it.

Decode caches roll as in the reference: a buffer of length L < max_len is
written at ``pos % L``.  The port writes K/V caches in place (one buffer per
layer for the whole generation) where the reference returns new arrays; the
RWKV and Mamba2 caches (token shifts, conv tail, recurrent state) are
replaced by new tensors each step, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import rwkv as RW
from repro_torch.models import ssm as SSM

ZERO_AUX = {"moe_lb_loss": 0.0, "moe_z_loss": 0.0}

_LATER = {
    "mla": "ROADMAP Queue A, 'Attention variants'",
    "sandwich_norm": "ROADMAP Queue A, 'Attention variants'",
    "moe": "ROADMAP Queue A, 'MoE'",
    "xattn": "ROADMAP Queue A, 'Encoder and cross-attention'",
    "dec": "ROADMAP Queue A, 'Encoder and cross-attention'",
    "gelu_mlp": "ROADMAP Queue A, 'Encoder and cross-attention'",
}


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: {_LATER.get(what, 'see ROADMAP.md')}")


# layer kind -> the one MLP setting the port runs with it
_KINDS = {"attn": "glu", "rwkv6": "none", "mamba2": "none",
          "shared_attn": "none"}


def check_supported(cfg: ModelConfig) -> None:
    for spec in cfg.plan:
        if spec.kind not in _KINDS:
            raise _not_ported(spec.kind)
        if spec.mlp != _KINDS[spec.kind]:
            raise _not_ported(spec.mlp)
    if cfg.sandwich_norm:
        raise _not_ported("sandwich_norm")
    if cfg.n_enc_layers or cfg.n_img_tokens:
        raise _not_ported("xattn")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One layer of the plan, with the reference's parameter names:
    ``attn``: norm1, attn, norm2, mlp; ``rwkv6``: norm1, rwkv, norm2;
    ``mamba2``: norm1, mamba; ``shared_attn``: norm1 only, which nothing
    reads (the reference's ``init_layer`` gives every layer one; the shared
    weights live in ``LM.shared_attn``)."""

    def __init__(self, gen, spec: LayerSpec, cfg: ModelConfig, device):
        super().__init__()
        dt = L.dtype_of(cfg.param_dtype)
        self.norm1 = L.init_rmsnorm(cfg.d_model, dt, device)
        if spec.kind == "attn":
            self.attn = L.init_attention(gen, cfg, device)
            self.norm2 = L.init_rmsnorm(cfg.d_model, dt, device)
            self.mlp = L.init_glu_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)
        elif spec.kind == "rwkv6":
            self.rwkv = RW.init_rwkv6(gen, cfg, device)
            self.norm2 = L.init_rmsnorm(cfg.d_model, dt, device)
        elif spec.kind == "mamba2":
            self.mamba = SSM.init_mamba2(gen, cfg, device)


class SharedAttn(nn.Module):
    """zamba2's shared block: attention over concat(hidden, embeddings)
    (input width 2·d_model), then a GLU MLP; one weight set for every
    ``shared_attn`` entry of the plan."""

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        dt = L.dtype_of(cfg.param_dtype)
        self.attn = L.init_attention(gen, cfg, device, d_in=2 * cfg.d_model)
        self.norm1 = L.init_rmsnorm(2 * cfg.d_model, dt, device)
        self.norm2 = L.init_rmsnorm(cfg.d_model, dt, device)
        self.mlp = L.init_glu_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)


def init_layer(gen, spec: LayerSpec, cfg: ModelConfig, device) -> Layer:
    return Layer(gen, spec, cfg, device)


def _padded_vocab(cfg: ModelConfig) -> int:
    """Embedding/lm-head rows padded to a multiple of 256, as in the
    reference; logits are sliced back to the true vocab."""
    return -(-cfg.vocab_size // 256) * 256


class LM(nn.Module):
    """Parameters of a decoder LM; ``layers`` follows ``cfg.plan``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        cfg.validate()
        check_supported(cfg)
        self.cfg = cfg
        dt = L.dtype_of(cfg.param_dtype)
        vpad = _padded_vocab(cfg)
        self.embed = L.embed_init(gen, (vpad, cfg.d_model), dt, device)
        self.final_norm = L.init_rmsnorm(cfg.d_model, dt, device)
        if not cfg.tie_embeddings:
            self.lm_head = L.dense_init(gen, (cfg.d_model, vpad), cfg.d_model,
                                        dt, device)
        self.layers = nn.ModuleList(
            [init_layer(gen, spec, cfg, device) for spec in cfg.plan])
        if any(s.kind == "shared_attn" for s in cfg.plan):
            self.shared_attn = SharedAttn(gen, cfg, device)

    def forward(self, tokens):
        return forward_train(self, tokens, self.cfg)[0]


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> LM:
    """Random parameters from ``gen`` (a generator on ``device``)."""
    return LM(cfg, gen, device)


# ---------------------------------------------------------------------------
# single layer application
# ---------------------------------------------------------------------------

def apply_layer(p, spec: LayerSpec, cfg: ModelConfig, x, *, positions,
                x0=None, cache=None, cache_pos=None, shared_params=None):
    """One layer of a kind ``check_supported`` admits.  ``x0`` is the
    embedding output of the current call (the shared block's second input).
    Returns (x, new_cache, aux)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    if spec.kind == "shared_attn":
        sp = shared_params
        h = L.rmsnorm(sp.norm1, torch.cat([x, x0], dim=-1), cfg.norm_eps)
        y, nc = _self_attn(sp.attn, h, cfg, spec, positions, cache, cache_pos)
        x = x + y
        h2 = L.rmsnorm(sp.norm2, x, cfg.norm_eps)
        x = x + L.glu_mlp(sp.mlp, h2.to(cdt), cdt).to(x.dtype)
        return x, nc, dict(ZERO_AUX)

    h = L.rmsnorm(p.norm1, x, cfg.norm_eps)
    if spec.kind == "mamba2":
        y, nc = SSM.mamba2_block(p.mamba, h, cfg, cache=cache)
        return x + y, nc, dict(ZERO_AUX)
    if spec.kind == "rwkv6":
        y, nc = RW.rwkv6_time_mix(p.rwkv, h, cfg, cache=cache)
        x = x + y
        h2 = L.rmsnorm(p.norm2, x, cfg.norm_eps)
        cm_cache = None if cache is None else {"shift_c": cache["shift_c"]}
        y2, new_shift = RW.rwkv6_channel_mix(p.rwkv, h2, cfg, cache=cm_cache)
        x = x + y2
        if cache is not None:
            nc = dict(nc, shift_c=new_shift.to(cache["shift_c"].dtype))
        return x, nc, dict(ZERO_AUX)

    y, new_cache = _self_attn(p.attn, h, cfg, spec, positions, cache, cache_pos)
    x = x + y
    h2 = L.rmsnorm(p.norm2, x, cfg.norm_eps)
    x = x + L.glu_mlp(p.mlp, h2.to(cdt), cdt).to(x.dtype)
    return x, new_cache, dict(ZERO_AUX)


def _self_attn(pa, h, cfg, spec, positions, cache, cache_pos):
    if cache is None:
        y, _ = L.attention(pa, h, cfg, spec, positions=positions)
        return y, None
    Lbuf = cache["k"].shape[1]
    if h.shape[1] == 1:  # decode: rolling write
        write_pos = cache_pos % Lbuf
        kv_len = min(cache_pos + 1, Lbuf)
        return _attn_decode_rolling(pa, h, cfg, spec, positions, cache,
                                    write_pos, kv_len)
    return _attn_prefill(pa, h, cfg, spec, positions, cache)


def _attn_prefill(pa, h, cfg, spec, positions, cache):
    """Run full-sequence attention, then lay the (possibly rolled) tail of
    the roped K/V into the cache buffers (slot = position % Lbuf)."""
    y, k, v = L.attention(pa, h, cfg, spec, positions=positions, return_kv=True)
    S, Lbuf = h.shape[1], cache["k"].shape[1]
    ck, cv = cache["k"], cache["v"]
    if S <= Lbuf:
        ck[:, :S] = k
        cv[:, :S] = v
    else:  # windowed cache smaller than prefill: token s -> slot s % Lbuf
        ck.copy_(torch.roll(k[:, -Lbuf:], S % Lbuf, dims=1))
        cv.copy_(torch.roll(v[:, -Lbuf:], S % Lbuf, dims=1))
    return y, {"k": ck, "v": cv}


def _attn_decode_rolling(pa, h, cfg, spec, positions, cache, write_pos, kv_len):
    B = h.shape[0]
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = L.dtype_of(cfg.compute_dtype)
    hc = h.to(cdt)
    q = (hc @ pa.wq.to(cdt)).reshape(B, 1, H, Dh)
    k = (hc @ pa.wk.to(cdt)).reshape(B, 1, KV, Dh)
    v = (hc @ pa.wv.to(cdt)).reshape(B, 1, KV, Dh)
    if cfg.qk_norm:
        q = L.rmsnorm(pa.qnorm, q, cfg.norm_eps)
        k = L.rmsnorm(pa.knorm, k, cfg.norm_eps)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    ck[:, write_pos] = k[:, 0]
    cv[:, write_pos] = v[:, 0]
    out = kops.decode_attention(q, ck, cv, kv_len=kv_len,
                                scale=L.attention_scale(cfg),
                                softcap_val=cfg.attn_softcap, window=None)
    o = out.reshape(B, 1, H * Dh) @ pa.wo.to(cdt)
    return o.to(h.dtype), {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# full stacks
# ---------------------------------------------------------------------------

def _embed(params, tokens, cfg):
    x = params.embed[tokens.long()].to(L.dtype_of(cfg.compute_dtype))
    if cfg.embed_scale:
        x = x * torch.sqrt(torch.tensor(cfg.d_model, dtype=x.dtype,
                                        device=x.device))
    return x


def _logits(params, x, cfg):
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    cdt = L.dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        logits = x.to(cdt) @ params.embed.to(cdt).T
    else:
        logits = x.to(cdt) @ params.lm_head.to(cdt)
    if cfg.final_softcap:
        logits = L.softcap(logits, cfg.final_softcap)
    if logits.shape[-1] != cfg.vocab_size:  # drop the padded vocab rows
        logits = logits[..., :cfg.vocab_size]
    return logits


def forward_train(params, tokens, cfg: ModelConfig):
    """Teacher-forced forward over full sequences -> logits, aux."""
    x = _embed(params, tokens, cfg)
    x0 = x
    shared = getattr(params, "shared_attn", None)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux_tot = dict(ZERO_AUX)
    for p, spec in zip(params.layers, cfg.plan):
        x, _, aux = apply_layer(p, spec, cfg, x, positions=positions, x0=x0,
                                shared_params=shared)
        aux_tot = {k: aux_tot[k] + aux[k] for k in aux_tot}
    return _logits(params, x, cfg), aux_tot


# ---------------------------------------------------------------------------
# caches / serving
# ---------------------------------------------------------------------------

def _cache_len(cfg: ModelConfig, spec: LayerSpec, max_len: int) -> int:
    w = spec.sliding_window or cfg.decode_window
    if spec.kind == "shared_attn" and cfg.decode_window:
        w = cfg.decode_window
    return min(w, max_len) if w else max_len


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch, max_len, dtype,
                     device):
    if spec.kind in ("attn", "shared_attn"):
        return L.init_attn_cache(cfg, batch, _cache_len(cfg, spec, max_len),
                                 dtype, device)
    if spec.kind == "mamba2":
        return SSM.init_mamba2_cache(cfg, batch, dtype, device)
    if spec.kind == "rwkv6":
        return RW.init_rwkv6_cache(cfg, batch, dtype, device)
    raise _not_ported(spec.kind)


def init_caches(cfg: ModelConfig, batch, max_len, dtype=torch.bfloat16,
                device="cuda") -> Dict[str, Any]:
    layers: List[Dict[str, torch.Tensor]] = [
        init_layer_cache(cfg, spec, batch, max_len, dtype, device)
        for spec in cfg.plan]
    return {"layers": layers, "pos": 0}


def forward_cached(params, tokens, caches, cfg: ModelConfig):
    """Prefill (S>1) or decode (S=1) through the cache stack."""
    S = tokens.shape[1]
    pos0 = caches["pos"]
    x = _embed(params, tokens, cfg)
    x0 = x
    shared = getattr(params, "shared_attn", None)
    positions = pos0 + torch.arange(S, device=x.device)
    new_layers = []
    for p, spec, c in zip(params.layers, cfg.plan, caches["layers"]):
        x, nc, _ = apply_layer(p, spec, cfg, x, positions=positions, x0=x0,
                               cache=c, cache_pos=pos0, shared_params=shared)
        new_layers.append(nc)
    logits = _logits(params, x[:, -1:] if S > 1 else x, cfg)
    return logits, {"layers": new_layers, "pos": pos0 + S}


def prefill(params, tokens, cfg: ModelConfig, max_len=None,
            cache_dtype=torch.bfloat16):
    caches = init_caches(cfg, tokens.shape[0], max_len or tokens.shape[1],
                         cache_dtype, tokens.device)
    return forward_cached(params, tokens, caches, cfg)


def decode_step(params, token, caches, cfg: ModelConfig):
    """token: (B, 1) integer. One autoregressive step."""
    logits, caches = forward_cached(params, token, caches, cfg)
    return logits[:, 0], caches
