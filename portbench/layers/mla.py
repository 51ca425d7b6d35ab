"""DeepSeek-V2's multi-head latent attention (MLA), the mixer of a layer:
queries per head of ``qk_nope_dim`` + ``qk_rope_dim``; keys and values
rebuilt from one RMS-normed latent of ``kv_lora_rank`` (no query LoRA);
one rotary key of ``qk_rope_dim`` shared by every head; values of
``v_head_dim``; causal softmax at scale 1 / sqrt(qk_nope + qk_rope); plain
RoPE.  The port runs the attention in ``flash_attention`` at head size
qk_nope + qk_rope, with the values padded to it; the bounds below count
the values at ``v_head_dim``, whatever the port pads."""
from __future__ import annotations

import torch

from portbench.layers import Kernel
from portbench.lib import work
from portbench.reference import ops


def _sizes(m):
    return (m["d_model"], m["n_heads"], m["kv_lora_rank"], m["qk_nope_dim"],
            m["qk_rope_dim"], m["v_head_dim"])


def params(m):
    d, H, r, dn, dr, dv = _sizes(m)
    return {"attn.wq": (d, H * (dn + dr)), "attn.wkv_a": (d, r),
            "attn.wk_rope": (d, dr), "attn.kv_norm.scale": (r,),
            "attn.wk_b": (r, H * dn), "attn.wv_b": (r, H * dv),
            "attn.wo": (H * dv, d)}


def forward(p, i, x, m, prec, x0=None, positions=None):
    """x plus the attention of RMSNorm(x): the layer up to its MLP."""
    g = lambda name: p[f"layers.{i}.{name}"]  # noqa: E731
    d, H, r, dn, dr, dv = _sizes(m)
    Bb, S, _ = x.shape
    h = ops.rmsnorm(x, g("norm1.scale"), m["norm_eps"])
    q = prec.mm(h, g("attn.wq")).reshape(Bb, S, H, dn + dr)
    q_rope = ops.rope(q[..., dn:], positions, m["rope_theta"])
    latent = ops.rmsnorm(prec.mm(h, g("attn.wkv_a")), g("attn.kv_norm.scale"),
                         m["norm_eps"])
    k_rope = ops.rope(prec.mm(h, g("attn.wk_rope"))[:, :, None, :], positions,
                      m["rope_theta"])
    k_nope = prec.mm(latent, g("attn.wk_b")).reshape(Bb, S, H, dn)
    v = prec.mm(latent, g("attn.wv_b")).reshape(Bb, S, H, dv)
    qf = torch.cat([q[..., :dn], q_rope], -1)
    kf = torch.cat([k_nope, k_rope.expand(Bb, S, H, dr)], -1)
    o = ops.attention(qf, kf, v, S, prec).reshape(Bb, S, H * dv)
    return x + prec.mm(o, g("attn.wo"))


def products(m) -> float:
    d, H, r, dn, dr, dv = _sizes(m)
    return d * H * (dn + dr) + d * r + d * dr + r * H * (dn + dv) + H * dv * d


def mixer_flops(m, seq_len, train, kv_len=None) -> float:
    d, H, r, dn, dr, dv = _sizes(m)
    if not train:
        return 2.0 * H * (dn + dr + dv) * kv_len
    return (work.flash_flops(1, seq_len, seq_len, H, dn + dr, dv, True)
            + work.flash_flops(1, seq_len, seq_len, H, dn + dr, dv, True,
                               backward=True)) / seq_len


def mla_fwd_bound(B, S, H, Dqk, Dv):
    """q and k read at Dqk, v read and the output written at Dv, the row
    log-sum-exp written; Q K^T at Dqk and P V at Dv over the causal
    pairs."""
    nbytes = 2 * B * S * H * (Dqk + Dv) * work.BF16 + B * H * S * work.F32
    flops = 2 * B * H * (Dqk + Dv) * work.valid_pairs(S, S, True, None, 0)
    return work.bound_s(nbytes, flops)


def mla_bwd_bound(B, S, H, Dqk, Dv):
    """q, k read and dq, dk written at Dqk; v, o, dO read and dv written at
    Dv; lse read.  Q K^T, dO V^T, P^T dO, dS K and dS^T Q over the causal
    pairs: 2 (3 Dqk + 2 Dv) a pair."""
    nbytes = 4 * B * S * H * (Dqk + Dv) * work.BF16 + B * H * S * work.F32
    flops = 2 * B * H * (3 * Dqk + 2 * Dv) * work.valid_pairs(S, S, True,
                                                              None, 0)
    return work.bound_s(nbytes, flops)


def launch_shape(m, rows, seq_len, tp=1):
    d, H, r, dn, dr, dv = _sizes(m)
    return dict(B=rows, S=seq_len, H=H // tp, Dqk=dn + dr, Dv=dv)


KERNEL = Kernel(name="flash_attention", own=("flash_fwd", "flash_bwd"),
                shared=(), launch_shape=launch_shape,
                fwd_bound=mla_fwd_bound, bwd_bound=mla_bwd_bound)
