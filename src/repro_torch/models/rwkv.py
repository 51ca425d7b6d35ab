"""RWKV6 "Finch" block (port of ``repro/models/rwkv.py``): time-mix with
data-dependent decay, and channel-mix.

As in the reference, the five-way data-dependent token-shift interpolation
(ddlerp) is reduced to learned static per-channel mixes, while the
data-dependent decay w = exp(-exp(w0 + lora(x))) is kept.  Under a mesh
the projections are column-parallel (wr, wk, wv, wg, ck, cr) and
row-parallel (wo, cv): the scan, the decode step and the state run on each
rank's heads.  Prefill runs the
WKV scan through :mod:`repro_torch.kernels.ops` (the CUDA kernel for CUDA
tensors); decode is one plain step against the carried (D, D) state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, dtype_of, init_rmsnorm, rmsnorm
from repro_torch.parallel.sharding import (flatten_heads, linear, rows,
                                          split_like, unflatten_heads)


def _heads(cfg: ModelConfig):
    return cfg.d_model // cfg.rwkv_head_dim


class RWKV6(nn.Module):
    """Parameters of one RWKV6 layer; attribute names are the reference's
    dict keys."""

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        d, D = cfg.d_model, cfg.rwkv_head_dim
        H = _heads(cfg)
        r_dec = cfg.rwkv_lora_decay
        dt = dtype_of(cfg.param_dtype)

        def full(val):
            return nn.Parameter(torch.full((d,), val, dtype=dt, device=device))

        for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g"):
            setattr(self, name, full(0.5))
        self.wr = dense_init(gen, (d, d), d, dt, device)
        self.wk = dense_init(gen, (d, d), d, dt, device)
        self.wv = dense_init(gen, (d, d), d, dt, device)
        self.wg = dense_init(gen, (d, d), d, dt, device)
        self.w0 = full(-0.6)  # base decay: w ~ exp(-exp(-0.6)) ~ 0.58
        self.w_lora_a = dense_init(gen, (d, r_dec), d, dt, device)
        self.w_lora_b = nn.Parameter(
            (torch.randn((r_dec, d), generator=gen, device=device) * 0.01).to(dt))
        self.u = nn.Parameter(
            (torch.randn((H, D), generator=gen, device=device) * 0.1).to(dt))
        self.ln_x = init_rmsnorm(d, dt, device)
        self.wo = dense_init(gen, (d, d), d, dt, device)
        # channel mix
        self.cmix_k = full(0.5)
        self.cmix_r = full(0.5)
        self.ck = dense_init(gen, (d, cfg.d_ff), d, dt, device)
        self.cv = dense_init(gen, (cfg.d_ff, d), cfg.d_ff, dt, device)
        self.cr = dense_init(gen, (d, d), d, dt, device)


def init_rwkv6(gen, cfg: ModelConfig, device) -> RWKV6:
    return RWKV6(gen, cfg, device)


def _token_shift(x, prev):
    """Shift the sequence right by one; position 0 gets ``prev`` (B,1,D) or
    zeros."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def rwkv6_time_mix(p, x, cfg: ModelConfig, *, cache=None):
    """x: (B,S,D). cache: {"shift_t": (B,1,D), "state": (B,H,Dh,Dh)}."""
    B, S, _ = x.shape
    D = cfg.rwkv_head_dim
    H = _heads(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    prev = cache["shift_t"].to(cdt) if cache is not None else None
    xx = _token_shift(xc, prev)

    def mix(m):
        return xc + (xx - xc) * getattr(p, m).to(cdt)

    r = linear(mix("mix_r"), p.wr.to(cdt))
    k = linear(mix("mix_k"), p.wk.to(cdt))
    v = linear(mix("mix_v"), p.wv.to(cdt))
    g = linear(mix("mix_g"), p.wg.to(cdt))
    # data-dependent decay (the Finch mechanism), in float32
    dd = linear(mix("mix_w"), p.w_lora_a.to(cdt))
    dd = linear(torch.tanh(dd), p.w_lora_b.to(cdt))
    logdecay = -torch.exp(p.w0.float() + dd.float())
    w = torch.exp(logdecay)  # in (0,1), per (B,S,d)

    rh, kh, vh = (unflatten_heads(t, H) for t in (r, k, v))
    wh = split_like(w.reshape(B, S, H, D), 2, rh, 2)  # r's heads
    new_cache = None
    if cache is not None and S == 1:
        st, y = kops.wkv6_decode(cache["state"], rh[:, 0], kh[:, 0], vh[:, 0],
                                 wh[:, 0], p.u.float())
        y = y[:, None]
        new_cache = {"shift_t": xc[:, -1:].to(cache["shift_t"].dtype),
                     "state": st}
    else:
        y = kops.wkv6_scan(rh, kh, vh, wh, p.u.float(),
                           chunk=min(cfg.ssm_chunk, S),
                           use_pallas=cfg.use_pallas, impl=cfg.wkv_impl,
                           subchunk=cfg.wkv_subchunk)
        if cache is not None:  # prefill
            new_cache = {"shift_t": xc[:, -1:].to(cache["shift_t"].dtype),
                         "state": _wkv_final_state(kh, vh, wh)}
    y = flatten_heads(y)
    y = rmsnorm(p.ln_x, y.to(cdt), cfg.norm_eps) * F.silu(g)
    out = linear(y, p.wo.to(cdt))
    return out.to(x.dtype), new_cache


def _wkv_final_state(k, v, w):
    """State after the full sequence: sum_s (prod_{j>s} w_j) k_s v_s^T."""
    lw = torch.log(torch.clamp(w.float(), 1e-12, 1.0))
    cl = torch.cumsum(lw, dim=1)
    tail = torch.exp(cl[:, -1:] - cl)  # (B,S,H,D)
    return torch.einsum("bshd,bshe->bhde", tail * k.float(), v.float())


def rwkv6_channel_mix(p, x, cfg: ModelConfig, *, cache=None):
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    prev = cache["shift_c"].to(cdt) if cache is not None else None
    xx = _token_shift(xc, prev)
    xk = xc + (xx - xc) * p.cmix_k.to(cdt)
    xr = xc + (xx - xc) * p.cmix_r.to(cdt)
    kk = torch.relu(linear(xk, p.ck.to(cdt))).square()
    vv = linear(kk, p.cv.to(cdt))
    rr = rows(torch.sigmoid(linear(xr, p.cr.to(cdt))))
    out = rr * vv
    new_shift = xc[:, -1:] if cache is not None else None
    return out.to(x.dtype), new_shift


def init_rwkv6_cache(cfg: ModelConfig, batch, dtype, device):
    H, D = _heads(cfg), cfg.rwkv_head_dim
    return {
        "shift_t": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
        "state": torch.zeros((batch, H, D, D), dtype=torch.float32, device=device),
    }
