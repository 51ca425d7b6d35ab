"""Wrapper of the CUDA RWKV6 WKV scan kernel (``csrc/wkv6_scan.cu``), the port
of ``repro/kernels/wkv6_scan.py``.

Same signature as the Pallas kernel: r, k, v, w (B,S,H,D) and u (H,D) ->
(B,S,H,D) in r's dtype.  r, k, v are float32 or bfloat16; w and u float32.
On a CUDA tensor it launches the kernel on the current stream or raises; on
a CPU tensor it runs the plain version (``ref.wkv6_chunked_ref``).
``chunk`` is the padding unit of the chunked algorithm: the plain version
needs S to be a multiple of it, the kernel takes any S (it walks 16-row
chunks of its own; ``ref.wkv6_subtile_ref`` mirrors its rounding).  ``launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0

_launch = None


def _kernel():
    global _launch
    if _launch is None:
        _launch = _build.bind("wkv6_scan", "wkv6_scan_fwd",
                              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                              + [ctypes.c_void_p])
    return _launch


def check_args(r, k, v, w, u):
    """Raise ValueError on anything the CUDA kernel does not take."""
    if any(t.dim() != 4 for t in (r, k, v, w)) or u.dim() != 2:
        raise ValueError("r, k, v, w must be 4-d (B,S,H,D) and u 2-d (H,D)")
    B, S, H, D = r.shape
    if any(tuple(t.shape) != (B, S, H, D) for t in (k, v, w)):
        raise ValueError(f"shape mismatch: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}")
    if tuple(u.shape) != (H, D):
        raise ValueError(f"shape mismatch: u {tuple(u.shape)} for H={H}, D={D}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported; kernel takes {HEAD_DIMS}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"dtypes {r.dtype}, {k.dtype}, {v.dtype}: kernel takes "
                         "one of float32 / bfloat16 for all of r, k, v")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"dtypes w {w.dtype}, u {u.dtype}: kernel takes float32")
    if len({t.device for t in (r, k, v, w, u)}) != 1:
        raise ValueError("r, k, v, w, u lie on different devices")
    if not all(t.is_contiguous() for t in (r, k, v, w, u)):
        raise ValueError("r, k, v, w, u must be contiguous")
    if min(B, S) < 1 or H > 65535 or B > 65535:
        raise ValueError(f"unsupported sizes B={B} S={S} H={H}")


def wkv6_scan(r, k, v, w, u, *, chunk=64):
    """r,k,v,w: (B,S,H,D); u: (H,D) -> (B,S,H,D)."""
    global launches
    if r.device.type == "cpu":
        return ref.wkv6_chunked_ref(r, k, v, w, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"no WKV6 kernel for device {r.device}")
    check_args(r, k, v, w, u)
    _build.refuse_grad("wkv6_scan", r, k, v, w, u)
    B, S, H, D = r.shape
    launch = _kernel()
    out = torch.empty_like(r)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
               u.data_ptr(), out.data_ptr(), B, S, H, D, DTYPES[r.dtype],
               stream)
    launches += 1
    return out
