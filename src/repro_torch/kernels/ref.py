"""Plain PyTorch versions of the attention kernels (port of
``repro/kernels/ref.py``).

``flash_attention_ref`` is the plain version of the CUDA flash kernel: the CPU
path of the port, the yardstick ``chip_smoke.py`` holds the kernel against on
the card, and the ``use_pallas="never"`` path.  It is chunked over KV blocks
with the same online softmax, so its memory stays O(S·block).  It computes in
the kernel's order: ``q·scale`` in float32, the dot, softcap, then the mask.

``naive_attention`` is the O(S²) oracle, in the reference's own order (dot,
then scale).  ``decode_attention_ref`` is one token against a cache; the
reference has no kernel for it, so it stays plain on every device.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _apply_softcap(logits, cap):
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def _mask(qpos, kpos, causal, window):
    mask = torch.ones(qpos.shape[0], kpos.shape[1], dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def naive_attention(q, k, v, *, causal=True, scale=None, softcap_val=None,
                    window=None, q_pos0=0):
    """O(S^2)-memory oracle. q: (B,S,H,D), k/v: (B,T,KV,D)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B, S, KV, g, D).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) * scale
    logits = _apply_softcap(logits, softcap_val)
    qpos = (torch.arange(S, device=q.device) + q_pos0)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = _mask(qpos, kpos, causal, window)
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True, scale=None, softcap_val=None,
                        window=None, q_pos0=0, block_k=1024):
    """Flash-style chunked attention (online softmax over KV blocks)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B, S, KV, g, D).float() * scale
    qpos = (torch.arange(S, device=q.device) + q_pos0)[:, None]
    m = torch.full((B, KV, g, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, g, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, g, S, D), dtype=torch.float32, device=q.device)
    for start in range(0, T, block_k):
        kc = k[:, start:start + block_k].float()
        vc = v[:, start:start + block_k].float()
        logits = torch.einsum("bskgd,btkd->bkgst", qf, kc)
        logits = _apply_softcap(logits, softcap_val)
        kpos = start + torch.arange(kc.shape[1], device=q.device)[None, :]
        logits = torch.where(_mask(qpos, kpos, causal, window), logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, vc)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.reshape(B, H, S, D).transpose(1, 2)  # (B,S,H,D) with H = KV*g
    return out.to(q.dtype).contiguous()


def decode_attention_ref(q, ck, cv, *, kv_len, scale=None, softcap_val=None,
                         window=None):
    """Single-token decode attention over a (B, T, KV, D) cache.

    kv_len is the number of valid cache entries (the new token is at
    kv_len-1).
    """
    B, S, H, D = q.shape
    if S != 1:
        raise ValueError(f"decode attention takes one query token, got S={S}")
    T, KV = ck.shape[1], ck.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B, KV, g, D).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qf, ck.float()) * scale
    logits = _apply_softcap(logits, softcap_val)
    t = torch.arange(T, device=q.device)
    mask = t < kv_len
    if window is not None:
        mask &= t >= kv_len - window
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w, cv.float())
    return out.reshape(B, 1, H, D).to(q.dtype)
