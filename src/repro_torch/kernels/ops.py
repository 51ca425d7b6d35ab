"""Dispatch between the CUDA kernels and their plain versions (port of
``repro/kernels/ops.py``).

Dispatch policy (``use_pallas``, the reference's field name):
  * ``"auto"``  — the CUDA kernel for a CUDA tensor, the plain version on
                  every other device (cpu, meta), as the reference takes its
                  plain path on every device but a TPU.  No fallback: a CUDA
                  tensor the kernel cannot take raises.
  * ``"never"`` — always the plain version (tests and ``chip_smoke.py``'s
                  yardstick; the main path never sets it).

Gradients.  On a CPU tensor the plain versions are differentiated by
autograd, as the reference differentiates its plain path.  On a CUDA tensor
``flash_attention`` under grad goes through the wrapper's autograd Function
(the forward kernel with its row log-sum-exp, then the backward kernel);
``wkv6_scan`` and ``ssd_scan`` have no backward kernel yet and raise there.

DTensors (a training step under a mesh) reach the kernels as each rank's
local batch rows, through ``parallel.sharding.on_local_shards``
(``local_map``): the dispatch above then reads the local shard's device.

The scans pad a ragged S to a multiple of ``chunk`` as the reference does
(zeros; w with 1.0, whose log-decay 0 makes the padding inert) and slice the
result back.  On the kernel path the inputs are made contiguous, since the
model hands over slices of a fused projection.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssdk
from repro_torch.kernels import wkv6_scan as wkvk
from repro_torch.parallel.sharding import on_local_shards


def _use_kernel(use_pallas, x) -> bool:
    if use_pallas not in ("auto", "never"):
        raise ValueError(f"use_pallas={use_pallas!r}: the port takes "
                         "'auto' or 'never'")
    return use_pallas == "auto" and x.device.type == "cuda"


def flash_attention(q, k, v, *, causal=True, scale=None, softcap_val=None,
                    window=None, q_pos0=0, use_pallas="auto"):
    kw = dict(causal=causal, scale=scale, softcap_val=softcap_val,
              window=window, q_pos0=q_pos0)

    def local(q, k, v):
        if _use_kernel(use_pallas, q):
            return fak.flash_attention(q, k, v, **kw)
        return ref.flash_attention_ref(q, k, v, **kw)
    return on_local_shards(local, q, k, v)


def decode_attention(q, ck, cv, *, kv_len, scale=None, softcap_val=None,
                     window=None):
    return ref.decode_attention_ref(
        q, ck, cv, kv_len=kv_len, scale=scale, softcap_val=softcap_val,
        window=window)


def _pad_seq(arrs, chunk, value=0.0):
    """Pad each tensor along axis 1 to a multiple of chunk."""
    S = arrs[0].shape[1]
    Sp = -(-S // chunk) * chunk
    if Sp == S:
        return list(arrs)
    out = []
    for a in arrs:
        pad = [0, 0] * (a.dim() - 2) + [0, Sp - S]  # last axis first
        out.append(F.pad(a, pad, value=value))
    return out


def ssd_scan(x, dt, A, B_, C, *, chunk=128, use_pallas="auto"):
    return on_local_shards(lambda *a: _ssd_scan(*a, chunk=chunk,
                                                use_pallas=use_pallas),
                           x, dt, A, B_, C)


def _ssd_scan(x, dt, A, B_, C, *, chunk, use_pallas):
    S = x.shape[1]
    chunk = min(chunk, S)
    # zero-pad ragged sequences: x=0, dt=0 contribute nothing to the state
    x, dt, B_, C = _pad_seq((x, dt, B_, C), chunk)
    if _use_kernel(use_pallas, x):
        y = ssdk.ssd_scan(x.contiguous(), dt.float().contiguous(),
                          A.float().contiguous(), B_.contiguous(),
                          C.contiguous(), chunk=chunk)
    else:
        y = ref.ssd_chunked_ref(x, dt, A, B_, C, chunk=chunk)
    return y[:, :S]


def ssd_decode(h, x, dt, A, B_, C):
    return ref.ssd_decode_ref(h, x, dt, A, B_, C)


def wkv6_scan(r, k, v, w, u, *, chunk=128, use_pallas="auto", impl="chunked",
              subchunk=16):
    return on_local_shards(lambda *a: _wkv6_scan(
        *a, chunk=chunk, use_pallas=use_pallas, impl=impl, subchunk=subchunk),
        r, k, v, w, u)


def _wkv6_scan(r, k, v, w, u, *, chunk, use_pallas, impl, subchunk):
    S = r.shape[1]
    chunk = min(chunk, S)
    # pad ragged sequences: r/k/v = 0 and w = 1 (log-decay 0) are inert
    r, k, v = _pad_seq((r, k, v), chunk)
    (w,) = _pad_seq((w,), chunk, value=1.0)
    if _use_kernel(use_pallas, r):
        y = wkvk.wkv6_scan(r.contiguous(), k.contiguous(), v.contiguous(),
                           w.float().contiguous(), u.float().contiguous(),
                           chunk=chunk)
    elif impl == "blocked":
        sub = min(subchunk, chunk)
        while chunk % sub:  # snap to a divisor of the chunk
            sub -= 1
        y = ref.wkv6_blocked_ref(r, k, v, w, u, chunk=chunk, subchunk=sub)
    else:
        y = ref.wkv6_chunked_ref(r, k, v, w, u, chunk=chunk)
    return y[:, :S]


def wkv6_decode(state, r, k, v, w, u):
    return ref.wkv6_decode_ref(state, r, k, v, w, u)
