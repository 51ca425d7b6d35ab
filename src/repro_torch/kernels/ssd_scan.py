"""Wrapper of the CUDA Mamba2 SSD scan kernel (``csrc/ssd_scan.cu``), the port
of ``repro/kernels/ssd_scan.py``.

Same signature as the Pallas kernel: x (B,S,H,P), dt (B,S,H), A (H,), B_ and
C (B,S,N) -> y (B,S,H,P) in x's dtype.  x, B_, C are float32 or bfloat16 (one
dtype); dt and A float32.  On a CUDA tensor it launches the kernel on the
current stream or raises; on a CPU tensor it runs the plain version
(``ref.ssd_chunked_ref``).  ``chunk`` is the padding unit of the chunked
algorithm: the plain version needs S to be a multiple of it, the kernel
takes any S.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0

_launch = None


def _kernel():
    global _launch
    if _launch is None:
        _launch = _build.bind("ssd_scan", "ssd_scan_fwd",
                              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                              + [ctypes.c_void_p])
    return _launch


def check_args(x, dt, A, B_, C):
    """Raise ValueError on anything the CUDA kernel does not take."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B_.dim() != 3 \
            or C.dim() != 3:
        raise ValueError("x must be (B,S,H,P), dt (B,S,H), A (H,), B_ and C "
                         "(B,S,N)")
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    if tuple(dt.shape) != (Bb, S, H) or tuple(A.shape) != (H,) \
            or tuple(B_.shape) != (Bb, S, N) or tuple(C.shape) != (Bb, S, N):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B_ "
                         f"{tuple(B_.shape)}, C {tuple(C.shape)}")
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim {P} not supported; kernel takes {HEAD_DIMS}")
    if N not in STATE_DIMS:
        raise ValueError(f"state dim {N} not supported; kernel takes "
                         f"{STATE_DIMS}")
    if x.dtype not in DTYPES or B_.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {B_.dtype}, {C.dtype}: kernel "
                         "takes one of float32 / bfloat16 for all of x, B_, C")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dtypes dt {dt.dtype}, A {A.dtype}: kernel takes "
                         "float32")
    if len({t.device for t in (x, dt, A, B_, C)}) != 1:
        raise ValueError("x, dt, A, B_, C lie on different devices")
    if not all(t.is_contiguous() for t in (x, dt, A, B_, C)):
        raise ValueError("x, dt, A, B_, C must be contiguous")
    if min(Bb, S) < 1 or H > 65535 or Bb > 65535:
        raise ValueError(f"unsupported sizes B={Bb} S={S} H={H}")


def ssd_scan(x, dt, A, B_, C, *, chunk=128):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); B_,C: (B,S,N) -> y: (B,S,H,P)."""
    global launches
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, dt, A, B_, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {x.device}")
    check_args(x, dt, A, B_, C)
    _build.refuse_grad("ssd_scan", x, dt, A, B_, C)
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    launch = _kernel()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
               C.data_ptr(), out.data_ptr(), Bb, S, H, P, N, DTYPES[x.dtype],
               stream)
    launches += 1
    return out
