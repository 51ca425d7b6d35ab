"""Collective helpers: wire-level gradient compression (port of
``repro/parallel/collectives.py``).

``int8_psum`` all-reduces a tensor with int8 payloads: every rank
quantizes its contribution against one shared absmax scale (all-reduced
with MAX first), the integer sum is all-reduced on int32 (the reference
widens it the same way, to avoid overflow; ring implementations keep int8
per hop) and the result is dequantized locally.  It runs over
``torch.distributed`` on any backend, gloo on the CPU and NCCL on the
card, and never falls back to a plain all-reduce.

``compressed_grad_allreduce`` takes gradients whose leading dim holds
per-shard partial gradients, split over one axis of a DeviceMesh (each
rank holds its shard, as DTensor ``Shard(0)`` or as the local tensor
itself): each rank sums its shard over that dim, and every rank gets the
int8-compressed sum over the axis, replicated.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def int8_psum(x: torch.Tensor, group=None, bits: int = 8) -> torch.Tensor:
    """All-reduce ``x`` over ``group`` with int8 payloads.

    Scales are all-reduced first (max), so every rank quantizes against
    the same scale and the integer sum is exact up to quantization.
    """
    qmax = float(2 ** (bits - 1) - 1)
    gmax = x.abs().max().float()
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(gmax, 1e-12) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(x.dtype) * scale.to(x.dtype)


def compressed_grad_allreduce(grads: Dict[str, torch.Tensor], mesh,
                              axis: str = "data",
                              bits: int = 8) -> Dict[str, torch.Tensor]:
    """All-reduce a per-shard partial gradient tree with int8 payloads.

    Each leaf enters split over ``axis`` on its leading dim (a DTensor, of
    which the local shard is taken, or this rank's shard itself); it leaves
    reduced over the axis and the same on every rank, as a plain tensor.
    """
    group = mesh.get_group(axis)

    def one(g):
        local = g.to_local() if isinstance(g, DTensor) else g
        return int8_psum(local.sum(dim=0), group, bits=bits)

    return {k: one(g) for k, g in grads.items()}
