"""FLOP accounting for the kernels: what a counter (the dry run's
``LocalFlopCounter``) is told a kernel call does, since a kernel launched
through ctypes is no operator a dispatch mode sees.

``counting(counter)`` registers a counter (an object with
``add_kernel_flops(name, n)``) while a block runs; ``count`` tells every
registered counter; ``uncounted`` runs a kernel's plain version with the
dispatch modes suspended, so that a meta or CPU run adds the same number
as the card's kernel and nothing of the plain version's own operators.
The registry is module-wide, not thread-local: a backward runs on
autograd's own thread.
"""
from __future__ import annotations

import contextlib

import numpy as np
from torch.utils._python_dispatch import _disable_current_modes

_COUNTERS: list = []


@contextlib.contextmanager
def counting(counter):
    """Register ``counter`` for kernel FLOPs while the block runs."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


def counting_active() -> bool:
    return bool(_COUNTERS)


def count(name: str, flops, *args, **kw) -> None:
    """Tell every registered counter that kernel ``name`` did
    ``flops(*args, **kw)`` operations (computed only while one is)."""
    if _COUNTERS:
        n = flops(*args, **kw)
        for c in _COUNTERS:
            c.add_kernel_flops(name, n)


def uncounted(fn, *args, **kw):
    """``fn`` with the dispatch modes (the counters) suspended."""
    if not _COUNTERS:
        return fn(*args, **kw)
    with _disable_current_modes():
        return fn(*args, **kw)


def valid_pairs(S, T, causal, window, q_pos0) -> int:
    """(query, key) pairs the attention mask keeps."""
    pos = q_pos0 + np.arange(S)
    hi = np.minimum(T, pos + 1) if causal else np.full(S, T)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(S, np.int64)
    return int(np.maximum(0, hi - lo).sum())


def flash_flops(q, k, v, causal, window, q_pos0, backward=False) -> float:
    """Multiply-adds x 2 of flash attention over the valid pairs: S = QK^T
    and PV forward; the recomputed S, dP, dV, dQ and dK backward."""
    B, S, H, D = q.shape
    pairs = valid_pairs(S, k.shape[1], causal, window, q_pos0)
    per = 3 * D + 2 * v.shape[-1] if backward else D + v.shape[-1]
    return 2.0 * B * H * pairs * per


def scan_flops(x, n, backward=False) -> float:
    """Multiply-adds x 2 of the (D x n) state products a token and head:
    forward, the update and the read-out; backward, the recomputed state,
    the gradient state's update, and the four products that read the state
    or the gradient state (WKV6: dr, dk, dv, dw; SSD: dC, dx, dB and the
    decay's <Gh, h>)."""
    B, S, H, D = x.shape
    return 2.0 * (6 if backward else 2) * B * S * H * D * n


def decode_flops(q, ck) -> float:
    """Multiply-adds x 2 of the plain decode attention's two products, q.K
    and p.V over every cache position (masked ones too): what a dispatch
    counter counts of the plain version, so the kernel counts the same."""
    B, _, H, D = q.shape
    return 4.0 * B * H * ck.shape[1] * D
