"""RWKV6 layer: the time mix (static token-shift mixes, the data-dependent
decay w = exp(-exp(w0 + tanh(x A) B)), WKV with bonus u, RMSNorm of the
heads' output gated by SiLU(g)) and the channel mix (squared ReLU, sigmoid
receptance).  The port runs the WKV in ``wkv6_scan``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.layers import Kernel
from portbench.lib import work
from portbench.reference import ops


def params(m):
    d, D, f = m["d_model"], m["head_dim"], m["d_ff"]
    out = {}
    for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g"):
        out["rwkv." + name] = (d,)
    for name in ("wr", "wk", "wv", "wg"):
        out["rwkv." + name] = (d, d)
    out.update({"rwkv.w0": (d,), "rwkv.w_lora_a": (d, m["lora_decay"]),
                "rwkv.w_lora_b": (m["lora_decay"], d), "rwkv.u": (d // D, D),
                "rwkv.ln_x.scale": (d,), "rwkv.wo": (d, d),
                "rwkv.cmix_k": (d,), "rwkv.cmix_r": (d,), "rwkv.ck": (d, f),
                "rwkv.cv": (f, d), "rwkv.cr": (d, d), "norm2.scale": (d,)})
    return out


def forward(p, i, x, m, prec, x0=None, positions=None):
    g = lambda name: p[f"layers.{i}.rwkv.{name}"]  # noqa: E731
    d, D = m["d_model"], m["head_dim"]
    H = d // D
    Bb, S, _ = x.shape
    eps = m["norm_eps"]
    h = ops.rmsnorm(x, p[f"layers.{i}.norm1.scale"], eps)
    hx = ops.shift(h) - h

    def proj(mix, w):
        return prec.mm(h + hx * g(mix), g(w))
    r, k, v, gate = (proj(f"mix_{c}", f"w{c}") for c in "rkvg")
    dd = prec.mm(torch.tanh(proj("mix_w", "w_lora_a")), g("w_lora_b"))
    lw = -torch.exp(g("w0") + dd)  # log of the decay w
    heads = [z.reshape(Bb, S, H, D) for z in (r, k, v, lw)]
    y = ops.wkv(*(prec(z) for z in heads[:3]), heads[3], g("u"),
                carry=prec.carry)
    y = ops.rmsnorm(y.reshape(Bb, S, d), g("ln_x.scale"), eps) * F.silu(gate)
    x = x + prec.mm(y, g("wo"))
    h2 = ops.rmsnorm(x, p[f"layers.{i}.norm2.scale"], eps)
    hx2 = ops.shift(h2) - h2
    kk = torch.relu(prec.mm(h2 + hx2 * g("cmix_k"), g("ck"))).square()
    rr = torch.sigmoid(prec.mm(h2 + hx2 * g("cmix_r"), g("cr")))
    return x + rr * prec.mm(kk, g("cv"))


def products(m) -> float:
    d, f, r = m["d_model"], m["d_ff"], m["lora_decay"]
    return 6 * d * d + 2 * d * r + 2 * d * f


def mixer_flops(m, seq_len, train, kv_len=None) -> float:
    P = m["head_dim"]
    H = m["d_model"] // P
    return work.scan_flops(1, 1, H, P, P) \
        + (work.scan_flops(1, 1, H, P, P, backward=True) if train else 0.0)


def wkv_fwd_bound(B, S, H, D):
    """r, k, v, y in bf16, w and u in float32, each once; the chunked
    algorithm's products at the kernel's 16-row chunks."""
    nbytes = 4 * B * S * H * D * work.BF16 + (B * S * H * D + H * D) * work.F32
    flops = 0
    for n in work.tiles(S, 16):
        pairs = n * (n - 1) // 2
        flops += 3 * pairs * D + 3 * n * D + 2 * (pairs + n) * D \
            + 4 * n * D * D + D * D
    return work.bound_s(nbytes, B * H * flops)


def wkv_bwd_bound(B, S, H, D):
    """r, k, v, dy read and dr, dk, dv written in bf16; w, u read and dw,
    du written in float32; six state products a token and head."""
    nbytes = 7 * B * S * H * D * work.BF16 \
        + 2 * (B * S * H * D + H * D) * work.F32
    return work.bound_s(nbytes, work.scan_flops(B, S, H, D, D, backward=True))


def launch_shape(m, rows, seq_len, tp=1):
    return dict(B=rows, S=seq_len, H=m["d_model"] // m["head_dim"] // tp,
                D=m["head_dim"])


STATE = True

KERNEL = Kernel(
    name="wkv6_scan",
    own=("wkv6_kernel", "wkv6_bwd_kernel", "wkv_sum_kernel", "wkv_sub_kernel",
         "sum_rows_kernel"),
    shared=("scan_chunks_kernel",),
    launch_shape=launch_shape, fwd_bound=wkv_fwd_bound, bwd_bound=wkv_bwd_bound)
