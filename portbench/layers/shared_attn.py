"""Zamba2's shared block: causal attention with RoPE over
RMSNorm(concat(hidden, embeddings)), then a SiLU-gated MLP; one weight set
for every application; keys older than ``window`` positions are not
attended.  The port runs the attention in ``flash_attention``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.layers import Kernel
from portbench.lib import work
from portbench.reference import ops

PRE = "shared_attn."


def params(m):
    return {}


def shared_params(m):
    d, H, KV, Dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return {PRE + "attn.wq": (2 * d, H * Dh), PRE + "attn.wk": (2 * d, KV * Dh),
            PRE + "attn.wv": (2 * d, KV * Dh), PRE + "attn.wo": (H * Dh, d),
            PRE + "norm1.scale": (2 * d,), PRE + "norm2.scale": (d,),
            PRE + "mlp.wi": (d, m["d_ff"]), PRE + "mlp.wg": (d, m["d_ff"]),
            PRE + "mlp.wo": (m["d_ff"], d)}


def forward(p, i, x, m, prec, x0, positions):
    g = lambda name: p[PRE + name]  # noqa: E731
    H, KV, Dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    if KV != H:
        raise ValueError("the reference's attention takes as many key heads "
                         "as query heads")
    Bb, S, _ = x.shape
    h = ops.rmsnorm(torch.cat([x, x0], -1), g("norm1.scale"), m["norm_eps"])
    q = prec.mm(h, g("attn.wq")).reshape(Bb, S, H, Dh)
    k = prec.mm(h, g("attn.wk")).reshape(Bb, S, KV, Dh)
    v = prec.mm(h, g("attn.wv")).reshape(Bb, S, KV, Dh)
    q = ops.rope(q, positions, m["rope_theta"])
    k = ops.rope(k, positions, m["rope_theta"])
    o = ops.attention(q, k, v, m["window"], prec).reshape(Bb, S, H * Dh)
    x = x + prec.mm(o, g("attn.wo"))
    h2 = ops.rmsnorm(x, g("norm2.scale"), m["norm_eps"])
    mlp = prec.mm(F.silu(prec.mm(h2, g("mlp.wg"))) * prec.mm(h2, g("mlp.wi")),
                  g("mlp.wo"))
    return x + mlp


def products(m) -> float:
    d = m["d_model"]
    hd, kvd = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
    return 2 * d * (hd + 2 * kvd) + hd * d + 3 * d * m["d_ff"]


def mixer_flops(m, seq_len, train, kv_len=None) -> float:
    H, D, w = m["n_heads"], m["head_dim"], m.get("window")
    if not train:
        return 4.0 * H * D * min(kv_len, w or kv_len)
    return (work.flash_flops(1, seq_len, seq_len, H, D, D, True, w)
            + work.flash_flops(1, seq_len, seq_len, H, D, D, True, w,
                               backward=True)) / seq_len


def flash_fwd_bound(B, S, H, KV, D, causal=True, window=None, lse=True):
    """q, k, v read and the output (and, in training, the row
    log-sum-exp) written once; 4 D products over the valid pairs."""
    nbytes = (2 * B * S * H * D + 2 * B * S * KV * D) * work.BF16 \
        + (B * H * S * work.F32 if lse else 0)
    flops = 4 * B * H * D * work.valid_pairs(S, S, causal, window, 0)
    return work.bound_s(nbytes, flops)


def flash_bwd_bound(B, S, H, KV, D, causal=True, window=None):
    """q, k, v, o, dO, lse read and dq, dk, dv written once; Q K^T,
    dO V^T, P^T dO, dS K and dS^T Q over the valid pairs, 2 D each."""
    nbytes = (4 * B * S * H * D + 4 * B * S * KV * D) * work.BF16 \
        + B * H * S * work.F32
    return work.bound_s(
        nbytes, 10 * D * B * H * work.valid_pairs(S, S, causal, window, 0))


def launch_shape(m, rows, seq_len, tp=1):
    return dict(B=rows, S=seq_len, H=m["n_heads"] // tp,
                KV=m["n_kv_heads"] // tp, D=m["head_dim"])


KERNEL = Kernel(name="flash_attention", own=("flash_fwd", "flash_bwd"),
                shared=(), launch_shape=launch_shape,
                fwd_bound=flash_fwd_bound, bwd_bound=flash_bwd_bound)
