"""The program's launch counters, and the device's synchronisation and
memory readings.

The counters are the kernel wrappers' module attributes (``launches``:
forward launches, a remat recompute counting again; ``bwd_launches``:
backward calls).  On a device without the kernels they stay 0.
"""
from __future__ import annotations

import importlib
from typing import Dict

import torch

from portbench import layers


def read() -> Dict[str, int]:
    """{kernel: launches, kernel_bwd: backward calls} of every layer
    kind's hand-written kernel."""
    out = {}
    for k in layers.kernels():
        m = importlib.import_module(k.module)
        out[k.name] = m.launches
        out[k.name + "_bwd"] = m.bwd_launches
    return out


def delta(before: Dict[str, int]) -> Dict[str, int]:
    now = read()
    return {k: now[k] - before[k] for k in now}


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if on_card(device):
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if not on_card(device):
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def release(device) -> None:
    """Give the freed memory back, and count the peak anew."""
    if on_card(device):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
