"""The yardstick's arithmetic: published peaks, the least time a kernel
call could take (its roofline bound), and the model FLOPs of a token.

Copied from the program's own sound arithmetic so that a later change to
the program cannot move it: the bound from ``chip_smoke.py`` (``_bound``;
each kernel's bytes and products, ``ssd_work``, ``wkv_work`` and the rest,
are with its layer kind in ``portbench/layers/``), the FLOP counts from
``repro_torch/kernels/flops.py`` (``valid_pairs``, ``flash_flops``,
``scan_flops``).  They take shapes, not tensors.  A bound counts each
input byte read once and each output byte written once, and the
algorithm's products at the bf16 tensor-core peak; the larger of the two
times is the bound.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s, bf16 tensor-core FLOP/s
# (at the card's full 700 W; the run prints the card's power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
BF16, F32 = 2, 4  # bytes an element


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def valid_pairs(S, T, causal, window, q_pos0) -> int:
    """(query, key) pairs the attention mask keeps."""
    pos = q_pos0 + np.arange(S)
    hi = np.minimum(T, pos + 1) if causal else np.full(S, T)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(S, np.int64)
    return int(np.maximum(0, hi - lo).sum())


def flash_flops(B, S, T, H, D, Dv, causal, window=None, q_pos0=0,
                backward=False) -> float:
    """Multiply-adds x 2 of flash attention over the valid pairs: S = QK^T
    and PV forward; the recomputed S, dP, dV, dQ and dK backward."""
    pairs = valid_pairs(S, T, causal, window, q_pos0)
    per = 3 * D + 2 * Dv if backward else D + Dv
    return 2.0 * B * H * pairs * per


def scan_flops(B, S, H, D, n, backward=False) -> float:
    """Multiply-adds x 2 of the (D x n) state products a token and head:
    forward, the update and the read-out; backward six."""
    return 2.0 * (6 if backward else 2) * B * S * H * D * n


def tiles(S, tile):
    """The lengths of a kernel's tiles along S."""
    return [min(tile, S - t0) for t0 in range(0, S, tile)]


# ---------------------------------------------------------------------------
# model FLOPs of a token, and a kernel's share of its roofline
# ---------------------------------------------------------------------------

def _per_layer(m, fn, mlps=False) -> float:
    """``fn`` of each layer's kind module summed over the plan; with
    ``mlps``, of its MLP's module too."""
    from portbench import layers
    entries = list(m.get("prologue", [])) + list(m["superblock"]) * m["n_repeat"]
    return float(sum(fn(mod) for e in entries for mod in (
        layers.parts(e) if mlps else layers.parts(e)[:1])))


def _products(m) -> float:
    """Weights a token multiplies by, counted as often as they are applied
    (a shared block at each application; the tied embedding as the output
    head; the depthwise conv's taps; a MoE layer's router, the experts a
    token is routed to and the shared ones)."""
    return m["d_model"] * m["vocab_size"] + _per_layer(
        m, lambda k: k.products(m), mlps=True)


def train_flops_per_token(m: dict, seq_len: int) -> float:
    """6 per product weight (forward 2, backward 4) plus attention and the
    scans forward and backward; a recompute (remat) is not counted."""
    return 6.0 * _products(m) + _per_layer(
        m, lambda k: k.mixer_flops(m, seq_len, True))


def decode_flops_per_token(m: dict, kv_len: int) -> float:
    """2 per product weight plus attention over ``kv_len`` keys and the
    scans' state products."""
    return 2.0 * _products(m) + _per_layer(
        m, lambda k: k.mixer_flops(m, 1, False, kv_len))


def roofline(ctx, name: str, kinds=None) -> Optional[float]:
    """A hand-written kernel's share (%) of its roofline over a traced
    window: the bound of every forward launch (a remat recompute counting
    again) and backward call, by the program's counters, at the step's
    launch shape, over the device time of the kernel's forward and
    backward in the trace.  Where several layer kinds run it
    (``ctx.shapes[name]``: {kind: launch shape}), each kind's share of the
    launches (``ctx.shares[name][kind]``: of the forward launches and of
    the backward calls, from the plan) counts at its own shape and bound.
    ``kinds``: None unless every kind that ran it is among them (the
    trace cannot split a kernel's time by kind).  None where it did not
    run."""
    from portbench import layers
    shapes = ctx.shapes.get(name)
    n_f, n_b = ctx.counters.get(name, 0), ctx.counters.get(name + "_bwd", 0)
    t = ctx.trace.kernel_seconds(name)
    if not shapes or not (n_f or n_b) or t <= 0:
        return None
    if kinds is not None and set(shapes) - set(kinds):
        return None
    decl = layers.kernel_kinds(name)
    shares = getattr(ctx, "shares", {}).get(name, {})
    least = 0.0
    for kind, shape in shapes.items():
        f, b = shares.get(kind, (1.0, 1.0))
        k = decl[kind]
        least += n_f * f * k.fwd_bound(**shape) + n_b * b * k.bwd_bound(**shape)
    return 100.0 * least / t
