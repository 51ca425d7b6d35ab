"""Language-model stack (port of ``repro/models/lm.py``).

A model is the reference's layer plan (``cfg.plan``: prologue, then the
superblock ``n_repeat`` times) held as an ``nn.ModuleList``; the reference's
``lax.scan`` over stacked blocks is a loop over layers here.  Layer kinds, as
in the reference:

  attn   — GQA self-attention (sliding window / softcap options)
  mla    — DeepSeek multi-head latent attention
  mamba2 — Mamba2 SSD block (zamba2)
  rwkv6  — RWKV6 time-mix + channel-mix
  xattn  — gated cross-attention to precomputed embeddings (llama-vision):
           ``x + tanh(xgate) * attn``, ``xgate`` a 0-d parameter
  dec    — self-attn + cross-attn + MLP (whisper decoder layer)
  shared_attn — attention whose weights live once at the top of ``LM`` and
           are shared by every application (zamba2's shared block); its
           input is concat(hidden, embeddings of the current call)

each with the MLP ``glu``, ``gelu_mlp``, ``moe`` (``res_mlp`` beside it under
``moe_dense_residual``) or ``none``, and ``sandwich_norm``'s post-norms
around the attention and MLP outputs.  Cross-attention reads ``enc``: the
whisper encoder's output (``LM.encoder``, ``n_enc_layers`` non-causal
``attn`` layers with the GELU MLP over the frame embeddings ``enc_embed``)
or the patch embeddings ``img_embed`` projected by ``LM.w_img``.  The
callers hand these in as ``extra``.

Training: ``forward_train`` runs each layer under ``cfg.remat`` and
``loss_fn`` is the reference's cross-entropy plus the MoE aux losses;
gradients come from autograd, through the flash kernel's
``autograd.Function`` on the card.

Decode caches roll as in the reference: a buffer of length L < max_len is
written at ``pos % L``.  The port writes K/V, cross-attention K/V and MLA
latent caches in place (one buffer per layer for the whole generation)
where the reference returns new arrays; the RWKV and Mamba2 caches (token
shifts, conv tail, recurrent state) are replaced by new tensors each step,
as in the reference.  Cross-attention K/V are computed from ``enc`` at
prefill, which attends over them in the compute dtype; decode reads them
back from the cache, cast to the compute dtype.

Under a mesh (``sharding.activation_rules``) the caches are DTensors
placed by ``sharding.cache_spec``, each layer gathers its weights over the
fsdp dims around its call (``with_gathered_params``) and keeps their
split over ``model``, and the embedding is looked up vocab-parallel.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, List

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import spans
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RW
from repro_torch.models import ssm as SSM
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import (constrain, linear, on_local_shards,
                                          run_local, with_gathered_params)

ZERO_AUX = {"moe_lb_loss": 0.0, "moe_z_loss": 0.0}
KINDS = ("attn", "mla", "mamba2", "rwkv6", "xattn", "dec", "shared_attn")
MLPS = ("glu", "gelu_mlp", "moe", "none")
# the whisper encoder's layers
ENC_SPEC = LayerSpec(kind="attn", mlp="gelu_mlp", causal=False)


def check_supported(cfg: ModelConfig) -> None:
    for spec in cfg.plan:
        if spec.kind not in KINDS:
            raise ValueError(f"unknown layer kind {spec.kind!r}; kinds: {KINDS}")
        if spec.mlp not in MLPS:
            raise ValueError(f"unknown MLP {spec.mlp!r}; MLPs: {MLPS}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_mlp(gen, spec: LayerSpec, cfg: ModelConfig, device):
    dt = L.dtype_of(cfg.param_dtype)
    if spec.mlp == "glu":
        return L.init_glu_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)
    if spec.mlp == "gelu_mlp":
        return L.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)
    return MOE.init_moe(gen, cfg, device)


class Layer(nn.Module):
    """One layer of the plan, with the reference's parameter names:
    norm1, then the mixer (``attn`` for attn, xattn, dec and mla; ``rwkv``;
    ``mamba``), ``xgate`` (xattn), ``xnorm`` and ``xattn`` (dec), then
    norm2 and ``mlp`` unless the MLP is ``none`` (``res_mlp`` beside a
    dense-residual MoE); rwkv6 has norm2 for its channel mix.  A
    ``shared_attn`` layer holds only the norm1 the reference gives it,
    which nothing reads (the shared weights live in ``LM.shared_attn``).
    Under ``sandwich_norm`` every layer has ``norm1_post``, and
    ``norm2_post`` where it has ``norm2``, as in the reference; only
    ``attn`` and ``mla`` read them."""

    def __init__(self, gen, spec: LayerSpec, cfg: ModelConfig, device):
        super().__init__()
        dt = L.dtype_of(cfg.param_dtype)
        self.norm1 = L.init_rmsnorm(cfg.d_model, dt, device)
        if spec.kind in ("attn", "xattn", "dec"):
            self.attn = L.init_attention(gen, cfg, device)
        elif spec.kind == "mla":
            self.attn = L.init_mla(gen, cfg, device)
        elif spec.kind == "rwkv6":
            self.rwkv = RW.init_rwkv6(gen, cfg, device)
        elif spec.kind == "mamba2":
            self.mamba = SSM.init_mamba2(gen, cfg, device)
        if spec.kind == "xattn":
            self.xgate = nn.Parameter(torch.zeros((), dtype=dt, device=device))
        elif spec.kind == "dec":
            self.xnorm = L.init_rmsnorm(cfg.d_model, dt, device)
            self.xattn = L.init_attention(gen, cfg, device)
        if spec.mlp != "none" and spec.kind != "rwkv6":
            self.norm2 = L.init_rmsnorm(cfg.d_model, dt, device)
            self.mlp = _init_mlp(gen, spec, cfg, device)
            if spec.mlp == "moe" and cfg.moe_dense_residual:
                self.res_mlp = L.init_glu_mlp(gen, cfg.d_model, cfg.d_ff, dt,
                                              device)
        if spec.kind == "rwkv6":
            self.norm2 = L.init_rmsnorm(cfg.d_model, dt, device)
        if cfg.sandwich_norm:
            self.norm1_post = L.init_rmsnorm(cfg.d_model, dt, device)
            if hasattr(self, "norm2"):
                self.norm2_post = L.init_rmsnorm(cfg.d_model, dt, device)


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


class Encoder(nn.Module):
    """whisper's encoder: ``n_enc_layers`` layers of ``ENC_SPEC``, then a
    final norm."""

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        self.blocks = nn.ModuleList([init_layer(gen, ENC_SPEC, cfg, device)
                                     for _ in range(cfg.n_enc_layers)])
        self.final_norm = L.init_rmsnorm(cfg.d_model,
                                         L.dtype_of(cfg.param_dtype), device)


def init_layer(gen, spec: LayerSpec, cfg: ModelConfig, device) -> Layer:
    return Layer(gen, spec, cfg, device)


def _padded_vocab(cfg: ModelConfig) -> int:
    """Embedding/lm-head rows padded to a multiple of 256, as in the
    reference; logits are sliced back to the true vocab."""
    return -(-cfg.vocab_size // 256) * 256


class LM(nn.Module):
    """Parameters of an LM; ``layers`` follows ``cfg.plan``.  ``encoder``
    (whisper) and ``w_img`` (the image projection, (d_vision, d_model))
    exist where the config has ``n_enc_layers`` / ``n_img_tokens``."""

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
        if cfg.n_enc_layers:
            self.encoder = Encoder(gen, cfg, device)
        if cfg.n_img_tokens:
            self.w_img = L.dense_init(gen, (cfg.d_vision, cfg.d_model),
                                      cfg.d_vision, dt, device)

    def forward(self, tokens, extra=None):
        return forward_train(self, tokens, self.cfg, extra)[0]


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> LM:
    """Random parameters from ``gen`` (a generator on ``device``)."""
    return LM(cfg, gen, device)


# ---------------------------------------------------------------------------
# single layer application
# ---------------------------------------------------------------------------

def _post(p, name, y, cfg):
    if cfg.sandwich_norm and hasattr(p, name):
        return L.rmsnorm(getattr(p, name), y, cfg.norm_eps)
    return y


def apply_layer(p, spec: LayerSpec, cfg: ModelConfig, x, *, positions,
                x0=None, enc=None, cache=None, cache_pos=None,
                shared_params=None):
    """One layer.  ``x0`` is the embedding output of the current call (the
    shared block's second input); ``enc`` the states cross-attention reads
    (None at decode, where they come from the cache).
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

    if spec.kind == "mamba2":
        y, new_cache = SSM.mamba2_block(p.mamba, h, cfg, cache=cache)
        x = x + y
    elif spec.kind == "mla":
        y, new_cache = L.mla_attention(p.attn, h, cfg, spec,
                                       positions=positions, cache=cache,
                                       cache_pos=cache_pos)
        x = x + _post(p, "norm1_post", y, cfg)
    elif spec.kind == "xattn":
        y, new_cache = _cross_attn(p.attn, h, cfg, enc, cache)
        x = x + torch.tanh(p.xgate).to(x.dtype) * y
    elif spec.kind == "dec":
        y, nc_self = _self_attn(p.attn, h, cfg, spec, positions, cache,
                                cache_pos)
        x = x + y
        hx = L.rmsnorm(p.xnorm, x, cfg.norm_eps)
        y2, nc_x = _cross_attn(p.xattn, hx, cfg, enc, cache)
        x = x + y2
        new_cache = None if cache is None else {**nc_self, **nc_x}
    else:
        y, new_cache = _self_attn(p.attn, h, cfg, spec, positions, cache,
                                  cache_pos)
        x = x + _post(p, "norm1_post", y, cfg)

    aux = dict(ZERO_AUX)
    if spec.mlp != "none":
        h2 = L.rmsnorm(p.norm2, x, cfg.norm_eps)
        if spec.mlp == "moe":
            y, aux = MOE.moe_layer(p.mlp, h2, cfg)
            if cfg.moe_dense_residual:  # arctic: dense MLP parallel to MoE
                y = y + L.glu_mlp(p.res_mlp, h2.to(cdt), cdt).to(y.dtype)
        elif spec.mlp == "glu":
            y = L.glu_mlp(p.mlp, h2.to(cdt), cdt).to(x.dtype)
        else:
            y = L.gelu_mlp(p.mlp, h2.to(cdt), cdt).to(x.dtype)
        x = x + _post(p, "norm2_post", y, cfg)
    return x, new_cache, aux


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


def _roll1(x, s):
    """``torch.roll(x, s, dims=1)`` as slices (a DTensor takes them)."""
    s %= x.shape[1]
    return torch.cat([x[:, x.shape[1] - s:], x[:, :x.shape[1] - s]], 1)


def _attn_prefill(pa, h, cfg, spec, positions, cache):
    """Run full-sequence attention, then lay the (possibly rolled) tail of
    the roped K/V into the cache buffers (slot = position % Lbuf)."""
    y, k, v = L.attention(pa, h, cfg, spec, positions=positions, return_kv=True)
    S, Lbuf = h.shape[1], cache["k"].shape[1]
    ck, cv = cache["k"], cache["v"]
    if S <= Lbuf:
        L.write_at(ck, 0, k)
        L.write_at(cv, 0, v)
    else:  # windowed cache smaller than prefill: token s -> slot s % Lbuf
        L.write_at(ck, 0, _roll1(k[:, -Lbuf:], S % Lbuf))
        L.write_at(cv, 0, _roll1(v[:, -Lbuf:], S % Lbuf))
    return y, {"k": ck, "v": cv}


def _attn_decode_rolling(pa, h, cfg, spec, positions, cache, write_pos, kv_len):
    cdt = L.dtype_of(cfg.compute_dtype)
    q, k, v = L.qkv(pa, h.to(cdt), cfg, positions)
    ck, cv = cache["k"], cache["v"]
    L.write_at(ck, write_pos, k)
    L.write_at(cv, write_pos, v)
    out = kops.decode_attention(q, ck, cv, kv_len=kv_len,
                                scale=L.attention_scale(cfg),
                                softcap_val=cfg.attn_softcap, window=None,
                                use_pallas=cfg.use_pallas)
    o = linear(shd.flatten_heads(out), pa.wo.to(cdt))
    return o.to(h.dtype), {"k": ck, "v": cv}


def _cross_attn(pa, h, cfg, enc, cache):
    """Cross-attention through the non-causal flash kernel at scale
    1/sqrt(head_dim), without RoPE or softcap.  K/V come from ``enc`` (train
    and prefill, in the compute dtype; a prefill also writes them into the
    cache, cast to its dtype) or, at decode (``enc`` None), from the cache
    cast back to the compute dtype."""
    cdt = L.dtype_of(cfg.compute_dtype)
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cache is not None and enc is None:
        xk, xv = cache["xk"].to(cdt), cache["xv"].to(cdt)
    else:
        src = enc.to(cdt)
        xk = shd.unflatten_heads(linear(src, pa.wk.to(cdt)), KV)
        xv = shd.unflatten_heads(linear(src, pa.wv.to(cdt)), KV)
    q = shd.unflatten_heads(linear(h.to(cdt), pa.wq.to(cdt)), H)
    if _split_seq(xk):  # a cache split along its positions (S = 1)
        out = kops.decode_attention(q, xk, xv, kv_len=xk.shape[1],
                                    scale=1.0 / math.sqrt(Dh))
    else:
        out = kops.flash_attention(q, xk, xv, causal=False,
                                   scale=1.0 / math.sqrt(Dh),
                                   use_pallas=cfg.use_pallas)
    o = linear(shd.flatten_heads(out), pa.wo.to(cdt)).to(h.dtype)
    if cache is None:
        return o, None
    if enc is not None:
        L.write_at(cache["xk"], 0, xk)
        L.write_at(cache["xv"], 0, xv)
    return o, {"xk": cache["xk"], "xv": cache["xv"]}


def _split_seq(t) -> bool:
    return isinstance(t, DTensor) and Shard(1) in t.placements


# ---------------------------------------------------------------------------
# full stacks
# ---------------------------------------------------------------------------

def _embed(params, tokens, cfg):
    x = shd.rows(_lookup(tokens, params.embed))
    x = x.to(L.dtype_of(cfg.compute_dtype))
    if cfg.embed_scale:
        x = x * torch.sqrt(torch.tensor(cfg.d_model, dtype=x.dtype,
                                        device=x.device))
    return constrain(x, "batch", None, None)


def _lookup(tokens, embed):
    """``embed[tokens]``.  Under a mesh, vocab-parallel: each rank looks
    up the tokens in the rows of ``embed`` it holds (zeros for the
    others), and the rows' partial sums are reduced where the next op
    reads them; the embedding is never gathered over ``model``."""
    if not isinstance(embed, DTensor):
        return embed[tokens.long()]
    tokens = tokens.redistribute(tokens.device_mesh,
                                 shd.batch_placements(tokens))
    v0, n = shd.local_offset(embed, 0)

    def look(t, e):
        t = t.long() - v0
        hit = (t >= 0) & (t < n)
        return e[t.clamp(0, n - 1)] * hit[..., None].to(e.dtype)
    out = [Partial() if p == Shard(0) and isinstance(pt, Replicate)
           else pt for p, pt in zip(embed.placements, tokens.placements)]
    return run_local(look, tokens, embed, out=out)


def _encode(params, cfg, enc_embed):
    """whisper's encoder over precomputed frame embeddings (the reference's
    stub frontend): ``ENC_SPEC`` layers at positions 0..enc_len-1, then
    the encoder's final norm."""
    x = enc_embed.to(L.dtype_of(cfg.compute_dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    for p in params.encoder.blocks:
        x, _, _ = apply_layer(p, ENC_SPEC, cfg, x, positions=positions)
    return L.rmsnorm(params.encoder.final_norm, x, cfg.norm_eps)


def _prep_enc(params, cfg, extra):
    """The states cross-attention reads: the encoder's output over
    ``extra["enc_embed"]``, or ``extra["img_embed"] @ w_img`` in the compute
    dtype; None for a model without either."""
    cdt = L.dtype_of(cfg.compute_dtype)
    if cfg.n_enc_layers:
        return _encode(params, cfg, extra["enc_embed"])
    if cfg.n_img_tokens:
        return shd.rows(linear(extra["img_embed"].to(cdt),
                               params.w_img.to(cdt)))
    return None


def _logits(params, x, cfg):
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    cdt = L.dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        logits = linear(x.to(cdt), params.embed.to(cdt).T)
    else:
        logits = linear(x.to(cdt), params.lm_head.to(cdt))
    if cfg.final_softcap:
        logits = L.softcap(logits, cfg.final_softcap)
    logits = constrain(logits, "batch", None, "vocab")
    if logits.shape[-1] != cfg.vocab_size:  # drop the padded vocab rows
        logits = logits[..., :cfg.vocab_size]
    return logits


# matrix products whose outputs ``remat="dots"`` keeps (the reference's
# dots_with_no_batch_dims_saveable: x @ W; attention's batched products
# and everything elementwise are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` under ``cfg.remat``: ``none`` keeps every activation,
    ``full`` recomputes the layer in the backward (the reference's
    ``jax.checkpoint``), ``dots`` keeps the matrix products' outputs and
    recomputes the rest.  A recompute runs the layer's forward again, the
    flash kernel included.  Outside grad there is nothing to recompute."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=partial(
                              create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat={cfg.remat!r}: none | full | dots")


def forward_train(params, tokens, cfg: ModelConfig, extra=None):
    """Teacher-forced forward over full sequences -> logits, aux.  ``extra``
    holds ``enc_embed`` / ``img_embed`` where the model reads them.  The
    layers after the prologue run under ``cfg.remat`` one at a time (the
    reference checkpoints its scan body, one superblock of them), and the
    hidden state is constrained to the batch split after each superblock,
    as the reference's scan body is.  Under a mesh each layer gathers its
    own weights over the fsdp dims inside its remat region
    (``with_gathered_params``); their splits over ``model`` stay."""
    x, aux = _train_layers(params, tokens, cfg, extra)
    return _logits(params, x, cfg), aux


def _train_layers(params, tokens, cfg: ModelConfig, extra=None):
    """:func:`forward_train` up to the final norm: (hidden, aux).  Each
    layer is a span ``layer.<kind>`` inside its remat region, so that the
    recompute opens it again, and its backward a span
    ``layer.<kind>.backward`` (``spans.LayerBackward``'s hooks on the
    tensors between the layers, outside the remat regions)."""
    x = _embed(params, tokens, cfg)
    x0 = x
    enc = _prep_enc(params, cfg, extra or {})
    shared = getattr(params, "shared_attn", None)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux_tot = dict(ZERO_AUX)
    bwd = spans.layer_backward()
    for i, (p, spec) in enumerate(zip(params.layers, cfg.plan)):
        def run(p, x, spec=spec):
            y, _, aux = apply_layer(p, spec, cfg, x, positions=positions,
                                    x0=x0, enc=enc, shared_params=shared)
            return y, aux

        name = f"layer.{spec.kind}"

        def layer(x, p=p, run=run, name=name):
            with spans.span(name):
                return with_gathered_params(p, run, x)
        if bwd is not None:
            bwd.boundary(x, name)
        n_pro = len(cfg.prologue)
        if i < n_pro:
            x, aux = layer(x)
        else:
            x, aux = _remat(cfg, layer, x)
            if (i - n_pro + 1) % len(cfg.superblock) == 0:
                x = constrain(x, "batch", None, None)
        aux_tot = {k: aux_tot[k] + aux[k] for k in aux_tot}
    if bwd is not None:
        bwd.boundary(x)
    return x, aux_tot


def gathered_top(params) -> Dict[str, torch.Tensor]:
    """{name: the parameter in compute placements
    (``sharding.gathered``)} for the model's parameters outside its
    layers (each layer gathers its own, ``with_gathered_params``)."""
    return {k: shd.gathered(p) for k, p in params.named_parameters()
            if not k.startswith("layers.")}


def _token_log_likelihood(logits, labels):
    lse = torch.logsumexp(logits.float(), dim=-1)  # (B,S)
    picked = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0].float()
    return picked - lse


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token cross-entropy over ``labels >= 0`` plus the aux
    losses, as the reference's: CE by gather and logsumexp over the float32
    cast of the logits, never the (B,S,V) float32 log-softmax.  ``batch``
    holds integer tensors ``tokens`` and ``labels`` (B,S) on the model's
    device, and the model's extras (``enc_embed`` / ``img_embed``) where
    it reads them.  Returns (loss, metrics)."""
    x, aux = _train_layers(params, batch["tokens"], cfg,
                           extra={k: v for k, v in batch.items()
                                  if k not in ("tokens", "labels")})
    with spans.span("head_loss"):
        logits = _logits(params, x, cfg)
        labels = batch["labels"].long()
        # a vocab-split DTensor is gathered to whole rows first (DTensor's
        # own vocab-parallel gather leaves a masked partial its reductions
        # mishandle)
        ll = on_local_shards(_token_log_likelihood, logits, labels)
        mask = (labels >= 0).float()
        loss = -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        loss = loss + 1e-2 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
    metrics = {"loss": loss, "ntokens": mask.sum(), **aux}
    return loss, metrics


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
    if spec.kind == "mla":
        return L.init_mla_cache(cfg, batch, max_len, dtype, device)
    if spec.kind == "mamba2":
        return SSM.init_mamba2_cache(cfg, batch, dtype, device)
    if spec.kind == "rwkv6":
        return RW.init_rwkv6_cache(cfg, batch, dtype, device)
    if spec.kind == "xattn":
        return _init_cross_cache(cfg, batch, cfg.n_img_tokens or cfg.enc_len,
                                 dtype, device)
    if spec.kind == "dec":
        c = L.init_attn_cache(cfg, batch, _cache_len(cfg, spec, max_len),
                              dtype, device)
        c.update(_init_cross_cache(cfg, batch, cfg.enc_len, dtype, device))
        return c
    raise ValueError(spec.kind)


def _init_cross_cache(cfg: ModelConfig, batch, T, dtype, device):
    shape = (batch, T, cfg.n_kv_heads, cfg.head_dim)
    return {"xk": torch.zeros(shape, dtype=dtype, device=device),
            "xv": torch.zeros(shape, dtype=dtype, device=device)}


def init_caches(cfg: ModelConfig, batch, max_len, dtype=torch.bfloat16,
                device="cuda") -> Dict[str, Any]:
    """Zeroed caches; under a mesh (``activation_rules``) each leaf a
    DTensor placed by ``sharding.cache_spec`` (each rank allocates its own
    block only)."""
    ctx = shd.current()
    if ctx is None:
        make = init_layer_cache
    else:
        def make(cfg, spec, batch, max_len, dtype, device):
            meta = init_layer_cache(cfg, spec, batch, max_len, dtype, "meta")
            return {k: shd.zeros_placed(t.shape, t.dtype, device, shd.cache_spec(
                k, t.shape, ctx.mesh, ctx.rules), ctx.mesh)
                for k, t in meta.items()}
    layers: List[Dict[str, torch.Tensor]] = [
        make(cfg, spec, batch, max_len, dtype, device) for spec in cfg.plan]
    return {"layers": layers, "pos": 0}


def forward_cached(params, tokens, caches, cfg: ModelConfig, extra=None):
    """Prefill (S>1) or decode (S=1) through the cache stack.  A prefill
    computes the cross-attention states from ``extra``; decode reads them
    from the caches."""
    S = tokens.shape[1]
    pos0 = caches["pos"]
    x = _embed(params, tokens, cfg)
    x0 = x
    enc = _prep_enc(params, cfg, extra or {}) if S > 1 else None
    shared = getattr(params, "shared_attn", None)
    positions = pos0 + torch.arange(S, device=x.device)
    new_layers = []
    for p, spec, c in zip(params.layers, cfg.plan, caches["layers"]):
        def run(p, x, spec=spec, c=c):
            return apply_layer(p, spec, cfg, x, positions=positions, x0=x0,
                               enc=enc, cache=c, cache_pos=pos0,
                               shared_params=shared)
        with spans.span(f"layer.{spec.kind}"):
            x, nc, _ = with_gathered_params(p, run, x)
        # a replaced entry (RWKV, Mamba2) keeps its cache's placements
        new_layers.append({k: shd.placed_like(v, c[k]) for k, v in nc.items()}
                          if nc is not None else nc)
    logits = _logits(params, x[:, -1:] if S > 1 else x, cfg)
    return logits, {"layers": new_layers, "pos": pos0 + S}


def prefill(params, tokens, cfg: ModelConfig, max_len=None, extra=None,
            cache_dtype=torch.bfloat16):
    caches = init_caches(cfg, tokens.shape[0], max_len or tokens.shape[1],
                         cache_dtype, tokens.device)
    return forward_cached(params, tokens, caches, cfg, extra=extra)


def decode_step(params, token, caches, cfg: ModelConfig):
    """token: (B, 1) integer. One autoregressive step."""
    logits, caches = forward_cached(params, token, caches, cfg)
    return logits[:, 0], caches
