"""Null simulators for overhead measurement (paper Sec. 2.3; the port of
``repro/sim/nullsim.py``).

``sleep_step`` reproduces the paper's ``sleep 1`` shell tasks (host-side
sleep, configurable); ``null_simulate`` is the device-side null (a
trivially small batched computation, no random draws) used to measure
the fused-bundle overhead floor.
"""
from __future__ import annotations

import time
from typing import Dict

import torch


def sleep_step(duration: float = 1.0):
    def step(ctx):
        time.sleep(duration)
    return step


def null_simulate(u: torch.Tensor,
                  draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"y": u.sum(-1) * 0.0 + 1.0}
