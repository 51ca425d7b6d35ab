"""Wrapper of the CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``, the port of ``repro/kernels/flash_attention.py``)
and its backward (``csrc/flash_attention_bwd.cu``).

Same signature as the Pallas kernel: q (B,S,H,D), k/v (B,T,KV,D) ->
(B,S,H,D) in q's dtype.  On a CUDA tensor it launches the kernels on the
current stream or raises: bfloat16 runs on the tensor cores (mma.sync, P
rounded to bf16; ``ref.flash_attention_tc_ref`` mirrors its rounding, and
``ref.flash_attention_bwd_tc_ref`` the backward's), float32 on scalar FMAs.
On a CPU tensor it runs the plain version (``ref.flash_attention_ref``),
whose gradient is PyTorch's autograd.

Gradients.  The Pallas kernel has no VJP; the reference differentiates its
plain path.  Here, when grad is enabled and q, k or v requires it, a CUDA
call goes through :class:`FlashAttentionFn`: its forward launches the
forward kernel with the row log-sum-exp stored, its backward launches the
backward kernel (``ref.flash_attention_bwd_ref`` is its plain version).
The backward takes ``q_pos0 = 0`` only, which training always passes, and
raises on anything else; nothing is sent to a plain version.  Without grad
the forward is one launch that stores no log-sum-exp, as serving runs it.

Head dims.  The forward and the backward take ``HEAD_DIMS`` (192 is MLA:
q/k at qk_nope 128 + qk_rope 64, v zero-padded to it; the backward splits
its dK/dV columns in two blocks there, see the kernel's notes).

``flash_attention_lse`` and ``flash_attention_bwd`` launch the two kernels
alone (the card tests and ``chip_smoke.py`` hold them to their plain
versions with them).  ``launches`` counts forward launches (a recompute under
``torch.utils.checkpoint`` counts again), ``bwd_launches`` backward calls
(each one call of the C entry, which runs two kernels: for bfloat16 the D_i
pass and one tensor-core grid of dK/dV and dQ blocks, for float32 the
scalar dQ and dK/dV kernels).
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flops import count, flash_flops

HEAD_DIMS = (16, 32, 64, 128, 192)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0

_launch = None
_launch_bwd = None


def _kernel():
    global _launch
    if _launch is None:
        _launch = _build.bind(
            "flash_attention", "flash_attention_fwd",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return _launch


def _bwd_kernel():
    global _launch_bwd
    if _launch_bwd is None:
        _launch_bwd = _build.bind(
            "flash_attention_bwd", "flash_attention_bwd",
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
            + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return _launch_bwd


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


def check_backward_args(q, k, *, window=None, q_pos0=0):
    """Raise ValueError on what the backward kernel does not take, on top
    of ``check_args``: an offset query block, and a row that sees no key
    (non-causal or causal with a window, S >= T + window)."""
    if q_pos0 != 0:
        raise ValueError(f"the backward kernel takes q_pos0 = 0, got {q_pos0}")
    S, T = q.shape[1], k.shape[1]
    if window is not None and S >= T + window:
        raise ValueError(f"rows past T + window - 1 see no key (S={S}, T={T},"
                         f" window={window}); the backward kernel refuses them")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward(q, k, v, scale, softcap_val, causal, window, q_pos0, lse=None):
    """One launch of the forward kernel; stores the row log-sum-exp into
    ``lse`` (float32 (B,H,S)) when it is given."""
    global launches
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    launch = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               None if lse is None else lse.data_ptr(),
               B, S, T, H, KV, D, DTYPES[q.dtype], float(scale),
               float(softcap_val or 0.0), int(bool(causal)), int(window or 0),
               int(q_pos0), _stream(q))
    launches += 1
    return out


def _aligned16(t):
    """``t``, or a copy that starts on a 16-byte boundary: the bf16 kernels
    copy 16-byte chunks (a contiguous view at an odd offset is rare)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _backward(q, k, v, out, lse, dout, scale, softcap_val, causal, window):
    """One call of the backward kernel -> (dq, dk, dv) in the inputs' dtype."""
    global bwd_launches
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if dout.shape != out.shape or dout.dtype != out.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not "
                         f"match out {tuple(out.shape)} {out.dtype}")
    if q.dtype == torch.bfloat16:
        q, k, v, out, dout = map(_aligned16, (q, k, v, out, dout))
    launch = _bwd_kernel()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               B, S, T, H, KV, D, DTYPES[q.dtype], float(scale),
               float(softcap_val or 0.0), int(bool(causal)), int(window or 0),
               _stream(q))
    bwd_launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the CUDA backward kernel as its gradient.  The
    forward depends on its arguments only, so a recompute under
    ``torch.utils.checkpoint`` gives the same output and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, scale, softcap_val, causal, window):
        B, S, H, _ = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, scale, softcap_val, causal, window, 0, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (scale, softcap_val, causal, window)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        count("flash_attention_bwd", flash_flops, q, k, v, ctx.opts[2],
              ctx.opts[3], 0, True)
        # autograd may hand over a strided gradient (a transpose, an expand)
        dq, dk, dv = _backward(q, k, v, out, lse, dout.contiguous(),
                               *ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention_lse(q, k, v, *, causal=True, scale=None,
                        softcap_val=None, window=None):
    """(out, lse): the forward kernel with the row log-sum-exp stored, as
    training launches it (float32 lse (B,H,S)); on a CPU tensor
    ``ref.flash_attention_lse_ref``."""
    if q.device.type == "cpu":
        return ref.flash_attention_lse_ref(
            q, k, v, causal=causal, scale=scale, softcap_val=softcap_val,
            window=window)
    check_args(q, k, v, softcap_val=softcap_val, window=window)
    check_backward_args(q, k, window=window)
    B, S, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, scale, softcap_val, causal, window, 0, lse), lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, scale=None,
                        softcap_val=None, window=None):
    """(dq, dk, dv): one call of the backward kernel on contiguous inputs;
    on a CPU tensor ``ref.flash_attention_bwd_ref``."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(
            q, k, v, out, lse, dout, causal=causal, scale=scale,
            softcap_val=softcap_val, window=window)
    check_args(q, k, v, softcap_val=softcap_val, window=window)
    check_backward_args(q, k, window=window)
    if not (out.is_contiguous() and dout.is_contiguous()
            and lse.is_contiguous() and lse.dtype == torch.float32
            and tuple(lse.shape) == (q.shape[0], q.shape[2], q.shape[1])):
        raise ValueError("out and dout must be contiguous, lse float32 "
                         "(B,H,S) and contiguous")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _backward(q, k, v, out, lse, dout, scale, softcap_val, causal,
                     window)


def flash_attention(q, k, v, *, causal=True, scale=None, softcap_val=None,
                    window=None, q_pos0=0):
    """q: (B,S,H,D); k,v: (B,T,KV,D) -> (B,S,H,D)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(
            q, k, v, causal=causal, scale=scale, softcap_val=softcap_val,
            window=window, q_pos0=q_pos0)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    check_args(q, k, v, softcap_val=softcap_val, window=window, q_pos0=q_pos0)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        check_backward_args(q, k, window=window, q_pos0=q_pos0)
        return FlashAttentionFn.apply(q, k, v, scale, softcap_val, causal,
                                      window)
    return _forward(q, k, v, scale, softcap_val, causal, window, q_pos0)
