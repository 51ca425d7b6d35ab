"""Wrapper of the CUDA decode attention (``csrc/decode_attention.cu``).

Same signature as ``ref.decode_attention_ref``, its plain version: q
(B,1,H,D) against a (B,T,KV,D) key / value cache -> (B,1,H,D) in q's dtype,
attending the positions t < kv_len (and t >= kv_len - window where a window
is given).  The JAX package has no kernel for it (its decode attention is
the plain function); this one exists because the plain version casts the
whole cache to float32 on every step.  On a CUDA tensor it launches the
kernel on the current stream or raises; on a CPU tensor it runs the plain
version.  The kernel reads the cache as stored (bfloat16 or float32), each
element once, and computes every product, sum and softmax weight in
float32, as the plain version does.

Layouts.  q contiguous; the cache (B,T,KV,D) with each position's KV heads
packed (strides (sb, st, D, 1)): a contiguous cache, or one sliced along
its KV heads (a rank's heads under a mesh), 16-byte aligned.  ck and cv
share their dtype and strides; q may have another dtype (float32 compute
over a bf16 cache).

Splits.  A block takes one (row, KV head) over all its positions; where
the B x KV blocks would not fill two waves of the card's SMs (a small
batch), ``num_splits`` cuts the positions into runs, each block writes a
partial (out, max, sum) and a second kernel merges them
(``ref.decode_attention_split_ref`` is that path's plain version).

``launches`` counts calls (a split call launches two kernels),
``split_launches`` the calls that took the split path.  There is no
gradient: decode runs without one, and the wrapper raises under grad.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ssd_scan import SMS

HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GROUPS = (1, 2, 4, 8, 16)  # query heads a block: the kernel's instances
MIN_SPLIT = 64  # positions a split holds at the least (four warp-tiles)

launches = 0
split_launches = 0

_launch = None


def _kernel():
    global _launch
    if _launch is None:
        _launch = _build.bind(
            "decode_attention", "decode_attention_fwd",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 6
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return _launch


def num_splits(B, KV, T, sms=SMS) -> int:
    """Runs the ``T`` attended positions are cut into: as many as keep the
    B x KV x runs blocks within 2 x ``sms`` (one wave at two blocks an SM;
    a block past it would start a second wave), each of at least
    ``MIN_SPLIT`` positions; 1 where the B x KV blocks fill that already.
    On an H100 at the serve phase's 4 x 552 caches, 64 against 256 took
    phi4's 24:8 from 15.4 to 10.7 us and starcoder2's 48:4 from 35 to 19
    (chip_smoke's decode shapes)."""
    return max(1, min(2 * sms // (B * KV), T // MIN_SPLIT))


def attended(kv_len, window):
    """The positions [lo, hi) a decode step attends."""
    return (0 if window is None else max(0, kv_len - window)), kv_len


def _group(g):
    """(query heads a block, head groups a KV head)."""
    G = next((n for n in GROUPS if n >= g), GROUPS[-1])
    return G, -(-g // G)


def check_args(q, ck, cv, *, kv_len, softcap_val=None, window=None):
    """Raise ValueError on anything the CUDA kernel does not take."""
    if q.dim() != 4 or ck.dim() != 4 or cv.dim() != 4:
        raise ValueError("q must be (B,1,H,D), ck and cv (B,T,KV,D)")
    B, S, H, D = q.shape
    Bk, T, KV, Dk = ck.shape
    if S != 1:
        raise ValueError(f"decode attention takes one query token, got S={S}")
    if tuple(cv.shape) != tuple(ck.shape) or Bk != B or Dk != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"ck {tuple(ck.shape)}, cv {tuple(cv.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"query heads {H} are not a multiple of KV heads {KV}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported; kernel takes {HEAD_DIMS}")
    if q.dtype not in DTYPES or ck.dtype not in DTYPES or cv.dtype != ck.dtype:
        raise ValueError(f"dtypes q {q.dtype}, ck {ck.dtype}, cv {cv.dtype}: "
                         "kernel takes float32 / bfloat16 for q, and one of "
                         "them for both caches")
    if not (q.device == ck.device == cv.device):
        raise ValueError("q, ck, cv lie on different devices")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    esz = ck.element_size()
    if (ck.stride() != cv.stride() or ck.stride(3) != 1 or ck.stride(2) != D
            or any(s * esz % 16 for s in ck.stride()[:2])
            or ck.data_ptr() % 16 or cv.data_ptr() % 16):
        raise ValueError(
            f"the caches must be contiguous in their KV heads and head dim "
            f"(strides (.., .., {D}, 1)), alike, and 16-byte aligned; got "
            f"{ck.stride()} and {cv.stride()}")
    if not 1 <= kv_len <= T:
        raise ValueError(f"kv_len {kv_len} outside [1, {T}]")
    if softcap_val is not None and softcap_val <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap_val}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, ck, cv)):
        raise ValueError("the decode attention kernel has no gradient")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def decode_attention(q, ck, cv, *, kv_len, scale=None, softcap_val=None,
                     window=None):
    """q: (B,1,H,D); ck, cv: (B,T,KV,D) -> (B,1,H,D)."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, ck, cv, kv_len=kv_len, scale=scale,
                                        softcap_val=softcap_val, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention kernel for device {q.device}")
    check_args(q, ck, cv, kv_len=kv_len, softcap_val=softcap_val,
               window=window)
    global launches, split_launches
    B, _, H, D = q.shape
    KV = ck.shape[2]
    G, groups = _group(H // KV)
    lo, hi = attended(kv_len, window)
    splits = num_splits(B, KV, hi - lo)
    chunk = -(-(hi - lo) // splits)
    splits = -(-(hi - lo) // chunk)  # no run left empty
    out = torch.empty_like(q)
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((B, H, splits, D), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((B, H, splits, 2), dtype=torch.float32,
                              device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    launch = _kernel()
    with torch.cuda.device(q.device):
        launch(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), out.data_ptr(),
               None if part_o is None else part_o.data_ptr(),
               None if part_ml is None else part_ml.data_ptr(),
               B, H, KV, D, G, groups, ck.stride(0), ck.stride(1), lo, hi,
               chunk, splits, DTYPES[ck.dtype], DTYPES[q.dtype], float(scale),
               float(softcap_val or 0.0), _stream(q))
    launches += 1
    split_launches += splits > 1
    return out
