"""Wrapper of the CUDA Mamba2 SSD scan kernels: the forward
(``csrc/ssd_scan.cu``, the port of ``repro/kernels/ssd_scan.py``) and its
backward (``csrc/ssd_scan_bwd.cu``).

Same signature as the Pallas kernel: x (B,S,H,P), dt (B,S,H), A (H,), B_ and
C (B,S,N) -> y (B,S,H,P) in x's dtype.  x, B_, C are float32 or bfloat16 (one
dtype); dt and A float32.  On a CUDA tensor it launches the kernel on the
current stream or raises; on a CPU tensor it runs the plain version
(``ref.ssd_chunked_ref``).  ``chunk`` is the padding unit of the chunked
algorithm: the plain version needs S to be a multiple of it, the kernel
takes any S.

Gradients.  The Pallas kernel has no VJP; the reference differentiates its
plain path.  Here, when grad is enabled and an input requires it, a CUDA
call goes through :class:`SSDScanFn`: its forward launches the forward
kernel and saves the inputs only, its backward launches the backward
kernel (``ref.ssd_scan_bwd_ref`` is its plain version): dx in x's dtype, dB
and dC in B_'s, ddt and dA in float32.  bf16 runs the chunk-parallel
tensor-core design (``ref.ssd_scan_bwd_tc_ref`` mirrors its rounding),
float32 PR 23's scalar walk.  ``launches`` counts forward launches,
``bwd_launches`` backward calls (each one call of a C entry: bf16, the
chunk summaries and their scan where S > 64, the chunks' gradients, and the
sums of dB and dC over head groups and of dA over b and chunks where more
than one holds them; float32, the scan and its sums).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flops import count, scan_flops

HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0

_launch = None
_launch_bwd = None
_launch_bwd_tc = None


def _kernel():
    global _launch
    if _launch is None:
        _launch = _build.bind("ssd_scan", "ssd_scan_fwd",
                              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                              + [ctypes.c_void_p])
    return _launch


def _bwd_kernel(dtype):
    global _launch_bwd, _launch_bwd_tc
    if dtype == torch.float32:
        if _launch_bwd is None:
            _launch_bwd = _build.bind(
                "ssd_scan_bwd", "ssd_scan_bwd",
                [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
                + [ctypes.c_void_p])
        return _launch_bwd
    if _launch_bwd_tc is None:
        _launch_bwd_tc = _build.bind(
            "ssd_scan_bwd", "ssd_scan_bwd_tc",
            [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return _launch_bwd_tc


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


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned16(t):
    """``t``, or a copy of it where it does not start on 16 bytes (a
    contiguous view at an odd offset)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(x, dt, A, B_, C):
    global launches
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    launch = _kernel()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
               C.data_ptr(), out.data_ptr(), Bb, S, H, P, N, DTYPES[x.dtype],
               _stream(x))
    launches += 1
    return out


CHUNK = 64  # time steps of a chunk of the backward kernels


def segment_steps(P, N):
    """Time steps of the float32 backward kernel's recomputed segment (64
    KB of P x N fp32 states in shared memory)."""
    return 16384 // (P * N)


SMS = 132  # the H100's SMs; the dry run sizes the same scratch anywhere


@functools.lru_cache(maxsize=None)
def heads_a_block(B, S, H):
    """Heads a block of the bf16 backward kernel takes in turn, adding
    their dB and dC rows in shared memory: the largest divisor of H that
    still leaves a block for each of the SMS SMs in its (chunks, H / hg, B)
    grid, else 1.  Fewer groups mean fewer partial rows to sum; at 64 heads
    of 64 x 64 two blocks fit an SM, so that grid is one wave.  At
    zamba2-1.2b's heads it picked the fastest group of every divisor at
    each shape timed (``tools/scan_bwd_variants.py --heads``: 1 x 8, 8 x
    128, 1 x 4096, 4 x 1024, 16 x 512, 16 x 4096)."""
    blocks = B * -(-S // CHUNK)
    fit = [d for d in range(1, H + 1)
           if H % d == 0 and blocks * (H // d) >= SMS]
    return max(fit, default=1)


def bwd_scratch(x, B_):
    """The backward kernel's scratch for x (B,S,H,P) and B_ (B,S,N), fp32
    on x's device.  bf16: dA's partial sums a (b, chunk, h); dB's and dC's
    partial rows a group of ``heads_a_block`` heads (none when one group
    holds them all); and, where S > CHUNK, each chunk's state in and
    gradient out (P x N each) and decay.  float32 (PR 23's kernel): dA's
    partial sums a (b, h); dB's and dC's a head; the state entering every
    CHUNK steps; and a block's states entering each segment of one
    chunk."""
    Bb, S, H, _ = x.shape
    hg = heads_a_block(Bb, S, H) if x.dtype == torch.bfloat16 else None
    return scratch_for(x, B_, hg)


def scratch_for(x, B_, hg):
    """``bwd_scratch`` at ``hg`` heads a block (None: float32)."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    nc = -(-S // CHUNK)
    f32 = dict(dtype=torch.float32, device=x.device)
    if hg is None:
        return (torch.empty((Bb, H), **f32),
                torch.empty((Bb, S, H, N), **f32),
                torch.empty((Bb, S, H, N), **f32),
                torch.empty((Bb, H, nc, P, N), **f32),
                torch.empty((Bb, H, CHUNK // segment_steps(P, N), P, N),
                            **f32))
    G = H // hg
    rows = (Bb, S, G, N) if G > 1 else (0,)
    states = (Bb, H, nc, P, N) if nc > 1 else (0,)
    return (torch.empty((Bb, nc, H), **f32),
            torch.empty(rows, **f32), torch.empty(rows, **f32),
            torch.empty(states, **f32), torch.empty(states, **f32),
            torch.empty((Bb, H, nc) if nc > 1 else (0,), **f32))


def _backward(x, dt, A, B_, C, dy):
    """One call of the backward kernel -> (dx, ddt, dA, dB, dC)."""
    global bwd_launches
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match "
                         f"x {tuple(x.shape)} {x.dtype}")
    launch = _bwd_kernel(x.dtype)
    if x.dtype == torch.bfloat16:  # the kernel copies 16-byte chunks
        x, B_, C, dy = map(_aligned16, (x, B_, C, dy))
    dx = torch.empty_like(x)
    ddt, dA = torch.empty_like(dt), torch.empty_like(A)
    dB, dC = torch.empty_like(B_), torch.empty_like(C)
    hg = heads_a_block(Bb, S, H) if x.dtype == torch.bfloat16 else None
    scratch = scratch_for(x, B_, hg)
    extra = [DTYPES[x.dtype]] if hg is None else [hg]
    with torch.cuda.device(x.device):
        launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
               C.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
               dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
               *(t.data_ptr() for t in scratch), Bb, S, H, P, N, *extra,
               _stream(x))
    bwd_launches += 1
    return dx, ddt, dA, dB, dC


class SSDScanFn(torch.autograd.Function):
    """The SSD scan with the CUDA backward kernel as its gradient; saves the
    inputs only."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C):
        ctx.save_for_backward(x, dt, A, B_, C)
        return _forward(x, dt, A, B_, C)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, dt, A, B_, C = ctx.saved_tensors
        count("ssd_scan_bwd", scan_flops, x, B_.shape[-1], backward=True)
        # autograd may hand over a strided gradient
        return _backward(x, dt, A, B_, C, dy.to(x.dtype).contiguous())


def ssd_scan_bwd(x, dt, A, B_, C, dy):
    """(dx, ddt, dA, dB, dC): one call of the backward kernel on contiguous
    inputs; on a CPU tensor ``ref.ssd_scan_bwd_ref``."""
    if x.device.type == "cpu":
        return ref.ssd_scan_bwd_ref(x, dt, A, B_, C, dy)
    check_args(x, dt, A, B_, C)
    if not dy.is_contiguous():
        raise ValueError("dy must be contiguous")
    return _backward(x, dt, A, B_, C, dy)


def ssd_scan(x, dt, A, B_, C, *, chunk=128):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); B_,C: (B,S,N) -> y: (B,S,H,P)."""
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, dt, A, B_, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {x.device}")
    check_args(x, dt, A, B_, C)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B_, C)):
        return SSDScanFn.apply(x, dt, A, B_, C)
    return _forward(x, dt, A, B_, C)
