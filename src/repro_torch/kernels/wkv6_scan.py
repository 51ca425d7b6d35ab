"""Wrapper of the CUDA RWKV6 WKV scan kernels: the forward
(``csrc/wkv6_scan.cu``, the port of ``repro/kernels/wkv6_scan.py``) and its
backward (``csrc/wkv6_scan_bwd.cu``).

Same signature as the Pallas kernel: r, k, v, w (B,S,H,D) and u (H,D) ->
(B,S,H,D) in r's dtype.  r, k, v are float32 or bfloat16; w and u float32.
On a CUDA tensor it launches the kernel on the current stream or raises; on
a CPU tensor it runs the plain version (``ref.wkv6_chunked_ref``).
``chunk`` is the padding unit of the chunked algorithm: the plain version
needs S to be a multiple of it, the kernel takes any S (it walks 16-row
chunks of its own; ``ref.wkv6_subtile_ref`` mirrors its rounding).

Gradients.  The Pallas kernel has no VJP; the reference differentiates its
plain path.  Here, when grad is enabled and an input requires it, a CUDA
call goes through :class:`WKV6ScanFn`: its forward launches the forward
kernel and saves the inputs only (the backward recomputes the states, see
:func:`bwd_scratch`), its backward launches the backward kernel
(``ref.wkv6_scan_bwd_ref`` is its plain version): dr, dk, dv in r's dtype,
dw and du in float32, dw zero where ``clip(w, 1e-12, 1)`` cuts (torch.clamp's
gradient).  bf16 runs the chunk-parallel tensor-core design
(``ref.wkv6_scan_bwd_tc_ref`` mirrors its rounding), float32 PR 23's scalar
walk.  ``launches`` counts forward launches, ``bwd_launches`` backward calls
(each one call of a C entry: bf16, the chunk summaries and their scan where
S > 64, the sub-tiles' gradients, and the sum of du over b and sub-tiles
where more than one holds it; float32, the scan and the sum of du over b).
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flops import count, scan_flops

HEAD_DIMS = (16, 32, 64)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0

_launch = None
_launch_bwd = None
_launch_bwd_tc = None


def _kernel():
    global _launch
    if _launch is None:
        _launch = _build.bind("wkv6_scan", "wkv6_scan_fwd",
                              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                              + [ctypes.c_void_p])
    return _launch


def _bwd_kernel(dtype):
    global _launch_bwd, _launch_bwd_tc
    if dtype == torch.float32:
        if _launch_bwd is None:
            _launch_bwd = _build.bind(
                "wkv6_scan_bwd", "wkv6_scan_bwd",
                [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
                + [ctypes.c_void_p])
        return _launch_bwd
    if _launch_bwd_tc is None:
        _launch_bwd_tc = _build.bind(
            "wkv6_scan_bwd", "wkv6_scan_bwd_tc",
            [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return _launch_bwd_tc


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


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned16(t):
    """``t``, or a copy of it where it does not start on 16 bytes (a
    contiguous view at an odd offset)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(r, k, v, w, u):
    global launches
    B, S, H, D = r.shape
    launch = _kernel()
    out = torch.empty_like(r)
    with torch.cuda.device(r.device):
        launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
               u.data_ptr(), out.data_ptr(), B, S, H, D, DTYPES[r.dtype],
               _stream(r))
    launches += 1
    return out


CHUNK = 64  # time steps of a chunk of the backward kernels
SUB = 16  # time steps of the bf16 backward kernel's sub-tiles


def segment_steps(D):
    """Time steps of the float32 backward kernel's recomputed segment (64
    KB of D x D fp32 states in shared memory)."""
    return 16384 // (D * D)


def bwd_scratch(r):
    """The backward kernel's scratch for r (B,S,H,D), fp32 on r's device.
    bf16: du's partial sums a (b, sub-tile) where more than one holds them;
    and, where S > CHUNK, each chunk's state in and gradient out (D x D
    each, 2x r's bf16 bytes each at D 64) and decay a row.  float32 (PR 23's
    kernel): du's partial sums a (b, h); the state entering every CHUNK
    steps; and a block's states entering each segment of one chunk."""
    B, S, H, D = r.shape
    nc = -(-S // CHUNK)
    f32 = dict(dtype=torch.float32, device=r.device)
    if r.dtype == torch.float32:
        return (torch.empty((B, H, D), **f32),
                torch.empty((B, H, nc, D, D), **f32),
                torch.empty((B, H, CHUNK // segment_steps(D), D, D), **f32))
    nsub = -(-S // SUB)
    states = (B, H, nc, D, D) if nc > 1 else (0,)
    return (torch.empty((B, nsub, H, D) if B * nsub > 1 else (0,), **f32),
            torch.empty(states, **f32), torch.empty(states, **f32),
            torch.empty((B, H, nc, D) if nc > 1 else (0,), **f32))


def _backward(r, k, v, w, u, dy):
    """One call of the backward kernel -> (dr, dk, dv, dw, du)."""
    global bwd_launches
    B, S, H, D = r.shape
    if tuple(dy.shape) != tuple(r.shape) or dy.dtype != r.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match "
                         f"r {tuple(r.shape)} {r.dtype}")
    launch = _bwd_kernel(r.dtype)
    if r.dtype == torch.bfloat16:  # the kernel copies 16-byte chunks
        r, k, v, w, dy = map(_aligned16, (r, k, v, w, dy))
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = torch.empty_like(u)
    scratch = bwd_scratch(r)
    extra = [DTYPES[r.dtype]] if r.dtype == torch.float32 else []
    with torch.cuda.device(r.device):
        launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
               u.data_ptr(), dy.data_ptr(), dr.data_ptr(), dk.data_ptr(),
               dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
               *(t.data_ptr() for t in scratch), B, S, H, D, *extra,
               _stream(r))
    bwd_launches += 1
    return dr, dk, dv, dw, du


class WKV6ScanFn(torch.autograd.Function):
    """The WKV6 scan with the CUDA backward kernel as its gradient; saves
    the inputs only."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return _forward(r, k, v, w, u)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        r, k, v, w, u = ctx.saved_tensors
        count("wkv6_scan_bwd", scan_flops, r, r.shape[-1], backward=True)
        # autograd may hand over a strided gradient
        return _backward(r, k, v, w, u, dy.to(r.dtype).contiguous())


def wkv6_scan_bwd(r, k, v, w, u, dy):
    """(dr, dk, dv, dw, du): one call of the backward kernel on contiguous
    inputs; on a CPU tensor ``ref.wkv6_scan_bwd_ref``."""
    if r.device.type == "cpu":
        return ref.wkv6_scan_bwd_ref(r, k, v, w, u, dy)
    check_args(r, k, v, w, u)
    if not dy.is_contiguous():
        raise ValueError("dy must be contiguous")
    return _backward(r, k, v, w, u, dy)


def wkv6_scan(r, k, v, w, u, *, chunk=64):
    """r,k,v,w: (B,S,H,D); u: (H,D) -> (B,S,H,D)."""
    if r.device.type == "cpu":
        return ref.wkv6_chunked_ref(r, k, v, w, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"no WKV6 kernel for device {r.device}")
    check_args(r, k, v, w, u)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        return WKV6ScanFn.apply(r, k, v, w, u)
    return _forward(r, k, v, w, u)
