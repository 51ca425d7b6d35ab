"""Mamba2 (state-space dual) block, the SSM layer of zamba2 (port of
``repro/models/ssm.py``).

Dims: d_inner = expand * d_model; n_ssm_heads = d_inner / ssm_head_dim; the
B/C projections are shared across heads (n_groups=1, as in zamba2).  Prefill
runs the SSD scan through :mod:`repro_torch.kernels.ops` (the CUDA kernel for
CUDA tensors); decode is one plain step against the carried (P, N) state.
Under a mesh ``w_in`` is column-parallel and its output gathered before the
split into segments, the conv runs on each rank's channels (``conv_w``'s
split), the scan and state on its heads, and ``w_out`` is row-parallel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, dtype_of, init_rmsnorm, rmsnorm
from repro_torch.parallel.sharding import (TP_AXIS, flatten_heads, linear, rows,
                                          run_local, split_like)


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads


class Mamba2(nn.Module):
    """Parameters of one Mamba2 layer; attribute names are the reference's
    dict keys (``D`` included)."""

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        d, N, W = cfg.d_model, cfg.ssm_state, cfg.ssm_conv_width
        d_inner, H = _dims(cfg)
        conv_ch = d_inner + 2 * N  # conv over (x, B, C)
        dt = dtype_of(cfg.param_dtype)
        # fused in-projection: [z, x, B, C, dt]
        self.w_in = dense_init(gen, (d, 2 * d_inner + 2 * N + H), d, dt, device)
        self.conv_w = nn.Parameter(
            (torch.randn((W, conv_ch), generator=gen, device=device) * 0.1).to(dt))
        self.A_log = nn.Parameter(torch.zeros(H, dtype=dt, device=device))
        self.dt_bias = nn.Parameter(torch.zeros(H, dtype=dt, device=device))
        self.D = nn.Parameter(torch.ones(H, dtype=dt, device=device))
        self.ssm_norm = init_rmsnorm(d_inner, dt, device)
        self.w_out = dense_init(gen, (d_inner, d), d_inner, dt, device)


def init_mamba2(gen, cfg: ModelConfig, device) -> Mamba2:
    return Mamba2(gen, cfg, device)


def _causal_conv(x, w, state=None):
    """Depthwise causal conv as the reference writes it, a sum of W shifted
    products.  x: (B,S,C); w: (W,C); state: (B,W-1,C) or None."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0][None, None]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i][None, None]
    new_state = xp[:, -(W - 1):] if W > 1 else None
    return out, new_state


def mamba2_block(p, x, cfg: ModelConfig, *, cache=None):
    """x: (B,S,D). cache: {"conv": (B,W-1,C), "ssm": (B,H,P,N)} for decode."""
    B, S, _ = x.shape
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    d_inner, H = _dims(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    # the segments split the projection's columns unevenly: read it whole
    zxbcdt = rows(linear(xc, p.w_in.to(cdt)))
    z, xi, Bc, Cc, dt = torch.split(zxbcdt, [d_inner, d_inner, N, N, H], dim=-1)
    conv_in = torch.cat([xi, Bc, Cc], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    # the conv + silu chain and the gate into the norm run in float32 and
    # round once, as the reference's fused elementwise code does under XLA
    w = p.conv_w.to(cdt).float()
    # under a mesh on each rank's rows and conv channels (conv_w's split)
    conv_in = split_like(conv_in.float(), 2, w, 1)
    if conv_state is None:
        conv_out = run_local(lambda x, w: _causal_conv(x, w)[0], conv_in, w)
        new_conv = None
    else:
        conv_out, new_conv = run_local(_causal_conv, conv_in, w, conv_state,
                                       out=_two(conv_in))
    conv_out = rows(F.silu(conv_out).to(cdt))
    xi, Bc, Cc = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dtv = F.softplus(dt.float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())
    xh = _split_heads(xi.reshape(B, S, H, P))

    if cache is not None and S == 1:
        h, y = kops.ssd_decode(cache["ssm"], xh[:, 0].float(), dtv[:, 0], A,
                               Bc[:, 0].float(), Cc[:, 0].float())
        y = y[:, None]  # (B,1,H,P)
        new_cache = {"conv": new_conv.to(cache["conv"].dtype), "ssm": h}
    else:
        y = kops.ssd_scan(xh, dtv, A, Bc, Cc, chunk=min(cfg.ssm_chunk, S),
                          use_pallas=cfg.use_pallas)
        new_cache = None
        if cache is not None:  # prefill: hand the final state to decode
            new_cache = {"conv": new_conv.to(cache["conv"].dtype),
                         "ssm": _final_state(xh, dtv, A, Bc, Cc)}
    y = y + p.D.float()[None, None, :, None] * xh.float()
    y = flatten_heads(y)
    y = rmsnorm(p.ssm_norm, y * F.silu(z.float()), cfg.norm_eps).to(cdt)
    out = linear(y, p.w_out.to(cdt))
    return out.to(x.dtype), new_cache


def _two(x):
    """The placements of two outputs placed as ``x`` (plain: None)."""
    pl = list(getattr(x, "placements", ()))
    return (pl, pl)


def _split_heads(x):
    """A DTensor ``x`` (B,S,H,P) split over ``TP_AXIS`` on its heads
    where they divide it (a slice of replicated rows), else as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = [Shard(2) if name == TP_AXIS and pl == Replicate()
            and x.shape[2] % mesh.size(i) == 0 else pl
            for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names,
                                               x.placements))]
    return x.redistribute(mesh, want)


def _final_state(x, dt, A, B_, C):
    """Final SSM state after the whole sequence (prefill -> decode)."""
    a = A[None, None, :] * dt  # (B,S,H)
    acs = torch.cumsum(a, dim=1)
    tail = torch.exp(acs[:, -1:, :] - acs)  # (B,S,H)
    return torch.einsum("bsh,bshp,bsn->bhpn", tail * dt, x.float(), B_.float())


def init_mamba2_cache(cfg: ModelConfig, batch, dtype, device):
    N, W = cfg.ssm_state, cfg.ssm_conv_width
    d_inner, H = _dims(cfg)
    return {
        "conv": torch.zeros((batch, W - 1, d_inner + 2 * N), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, cfg.ssm_head_dim, N), dtype=torch.float32,
                           device=device),
    }
