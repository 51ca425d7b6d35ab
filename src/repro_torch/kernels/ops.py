"""Dispatch between the CUDA kernels and their plain versions (port of
``repro/kernels/ops.py``).

Dispatch policy (``use_pallas``, the reference's field name):
  * ``"auto"``  — the CUDA kernel for a CUDA tensor, the plain version for a
                  CPU tensor.  No fallback: a CUDA tensor the kernel cannot
                  take raises.
  * ``"never"`` — always the plain version (tests and ``chip_smoke.py``'s
                  yardstick; the main path never sets it).
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import ref


def flash_attention(q, k, v, *, causal=True, scale=None, softcap_val=None,
                    window=None, q_pos0=0, use_pallas="auto"):
    kw = dict(causal=causal, scale=scale, softcap_val=softcap_val,
              window=window, q_pos0=q_pos0)
    if use_pallas == "never":
        return ref.flash_attention_ref(q, k, v, **kw)
    if use_pallas != "auto":
        raise ValueError(f"use_pallas={use_pallas!r}: the port takes "
                         "'auto' or 'never'")
    return fak.flash_attention(q, k, v, **kw)


def decode_attention(q, ck, cv, *, kv_len, scale=None, softcap_val=None,
                     window=None):
    return ref.decode_attention_ref(
        q, ck, cv, kv_len=kv_len, scale=scale, softcap_val=softcap_val,
        window=window)
