"""Mamba2 (SSD) block: fused in-projection to [z, x, B, C, dt], depthwise
causal conv and SiLU over [x, B, C], the state space dual
h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D x_t, gated
RMSNorm, out-projection.  The port runs the scan in ``ssd_scan``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.layers import Kernel
from portbench.lib import work
from portbench.reference import ops


def _sizes(m):
    d, N, P = m["d_model"], m["ssm_state"], m["ssm_head_dim"]
    di = m["ssm_expand"] * d
    return d, di, N, P, di // P


def params(m):
    d, di, N, P, H = _sizes(m)
    return {"mamba.w_in": (d, 2 * di + 2 * N + H),
            "mamba.conv_w": (m["ssm_conv_width"], di + 2 * N),
            "mamba.A_log": (H,), "mamba.dt_bias": (H,), "mamba.D": (H,),
            "mamba.ssm_norm.scale": (di,), "mamba.w_out": (di, d)}


def forward(p, i, x, m, prec, x0=None, positions=None):
    g = lambda name: p[f"layers.{i}.{name}"]  # noqa: E731
    d, di, N, P, H = _sizes(m)
    Bb, S, _ = x.shape
    h = ops.rmsnorm(x, g("norm1.scale"), m["norm_eps"])
    z, xi, Bm, Cm, dt = torch.split(prec.mm(h, g("mamba.w_in")),
                                    [di, di, N, N, H], -1)
    conv = F.silu(ops.causal_conv(torch.cat([xi, Bm, Cm], -1),
                                  g("mamba.conv_w")))
    xi, Bm, Cm = torch.split(conv, [di, N, N], -1)
    dtv = F.softplus(dt + g("mamba.dt_bias"))
    A = -torch.exp(g("mamba.A_log"))
    xh = xi.reshape(Bb, S, H, P)
    y = ops.ssd(prec(xh), dtv, A, prec(Bm), prec(Cm), carry=prec.carry)
    y = (y + g("mamba.D")[:, None] * xh).reshape(Bb, S, di)
    y = ops.rmsnorm(y * F.silu(z), g("mamba.ssm_norm.scale"), m["norm_eps"])
    return x + prec.mm(y, g("mamba.w_out"))


def products(m) -> float:
    d, di, N, P, H = _sizes(m)
    return d * (2 * di + 2 * N + H) + di * d + m["ssm_conv_width"] * (di + 2 * N)


def mixer_flops(m, seq_len, train, kv_len=None) -> float:
    d, di, N, P, H = _sizes(m)
    return work.scan_flops(1, 1, H, P, N) \
        + (work.scan_flops(1, 1, H, P, N, backward=True) if train else 0.0)


def ssd_fwd_bound(B, S, H, P, N):
    """x, y, B, C in bf16, dt and A in float32, each once; the chunked
    algorithm's products at the kernel's 64-row tiles."""
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * work.BF16 \
        + (B * S * H + H) * work.F32
    flops = 0
    for n in work.tiles(S, 64):
        pairs = n * (n + 1) // 2
        flops += 2 * pairs * N + 3 * pairs + 2 * pairs * P + 4 * n * N * P \
            + P * N
    return work.bound_s(nbytes, B * H * flops)


def ssd_bwd_bound(B, S, H, P, N):
    """x, dy read and dx written; B, C read and dB, dC written; dt, A read
    and ddt, dA written (float32); six state products a token and head."""
    nbytes = 3 * B * S * H * P * work.BF16 + 4 * B * S * N * work.BF16 \
        + 2 * (B * S * H + H) * work.F32
    return work.bound_s(nbytes, work.scan_flops(B, S, H, P, N, backward=True))


def launch_shape(m, rows, seq_len, tp=1):
    d, di, N, P, H = _sizes(m)
    return dict(B=rows, S=seq_len, H=H // tp, P=P, N=N)


STATE = True

KERNEL = Kernel(
    name="ssd_scan",
    own=("ssd_tc_kernel", "ssd_f32_kernel", "ssd_bwd_kernel", "ssd_sum_kernel",
         "ssd_chunk_kernel", "ssd_finish_kernel", "sum_mid_kernel"),
    shared=("scan_chunks_kernel",),
    launch_shape=launch_shape, fwd_bound=ssd_fwd_bound, bwd_bound=ssd_bwd_bound)
