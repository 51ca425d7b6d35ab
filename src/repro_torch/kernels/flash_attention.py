"""Wrapper of the CUDA flash-attention forward kernel (``csrc/flash_attention.cu``),
the port of ``repro/kernels/flash_attention.py``.

Same signature as the Pallas kernel: q (B,S,H,D), k/v (B,T,KV,D) ->
(B,S,H,D) in q's dtype.  On a CUDA tensor it launches the kernel on the
current stream or raises: bfloat16 runs on the tensor cores (mma.sync, P
rounded to bf16; ``ref.flash_attention_tc_ref`` mirrors its rounding),
float32 on scalar FMAs.  On a CPU tensor it runs the plain version
(``ref.flash_attention_ref``).  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0

_launch = None


def _kernel():
    global _launch
    if _launch is None:
        _launch = _build.bind(
            "flash_attention", "flash_attention_fwd",
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return _launch


def check_args(q, k, v, *, softcap_val=None, window=None, q_pos0=0):
    """Raise ValueError on anything the CUDA kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-d: (B,S,H,D), (B,T,KV,D)")
    B, S, H, D = q.shape
    Bk, T, KV, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"query heads {H} are not a multiple of KV heads {KV}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported; kernel takes {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: kernel "
                         "takes one of float32 / bfloat16 for all three")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if min(B, S, T) < 1 or H > 65535 or B > 65535:
        raise ValueError(f"unsupported sizes B={B} S={S} T={T} H={H}")
    if softcap_val is not None and softcap_val <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap_val}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_pos0 < 0:
        raise ValueError(f"q_pos0 must be >= 0, got {q_pos0}")


def flash_attention(q, k, v, *, causal=True, scale=None, softcap_val=None,
                    window=None, q_pos0=0):
    """q: (B,S,H,D); k,v: (B,T,KV,D) -> (B,S,H,D)."""
    global launches
    if q.device.type == "cpu":
        return ref.flash_attention_ref(
            q, k, v, causal=causal, scale=scale, softcap_val=softcap_val,
            window=window, q_pos0=q_pos0)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    check_args(q, k, v, softcap_val=softcap_val, window=window, q_pos0=q_pos0)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    launch = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               B, S, T, H, KV, D, DTYPES[q.dtype], float(scale),
               float(softcap_val or 0.0), int(bool(causal)), int(window or 0),
               int(q_pos0), stream)
    launches += 1
    return out
