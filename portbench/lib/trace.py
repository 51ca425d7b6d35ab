"""Device trace of a bounded run of steps, and its reduction.

``profiled`` runs the steps under ``torch.profiler`` with CUDA activity
alone, exports the chrome trace into a temporary directory under TMPDIR
and reads the device events (kernels, copies and sets) from it, as
``chip_smoke.py``'s ``profile_run_trace`` does: the profiler's event tree
takes minutes to build for a step of tens of thousands of kernels.  The
traced window is the host's time from a synchronised start to a
synchronised end, so every device event of the steps lies inside it.  The
device is busy over the union of the events' intervals.

Kernel groups are ``chip_smoke.py``'s (``_kernel_group``): the
hand-written kernels (each layer kind's ``KERNEL``, its forward and
backward together), matrix products (cuBLAS), collectives (NCCL's
kernels, on several cards), copies and casts, the rest;
except that copies and casts are the kernels with "copy" in their name
(PyTorch runs every dtype cast as a copy: ``direct_copy_kernel_cuda``,
``bfloat16_copy_kernel_cuda``), since "cast" also names the templates of
kernels that cast nothing (``gpu_kernel_impl_nocast``,
``LoadWithoutCast``).
"""
from __future__ import annotations

import functools
import json
import os
import tempfile
import time
from typing import Callable, List, Tuple

from portbench import layers

# kernel-name fragments: matrix products (cuBLAS / cuBLASLt), copies (and
# with them dtype casts)
GEMM = ("gemm", "nvjet", "xmma", "cutlass")
COLLECTIVE = "nccl"
COPY = "copy"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_group(name: str) -> str:
    """``hand_written``, ``gemm``, ``collective``, ``copy_cast`` or
    ``other``."""
    low = name.lower()
    if _has(low, _hand_written()):
        return "hand_written"
    return ("gemm" if _has(low, GEMM) else
            "collective" if COLLECTIVE in low else
            "copy_cast" if COPY in low else "other")


@functools.lru_cache(maxsize=None)
def _hand_written() -> Tuple[str, ...]:
    return tuple(f for k in layers.kernels() for f in k.own + k.shared)


def _has(name: str, frags) -> bool:
    return any(f in name for f in frags)


class Trace:
    """Device events ``(name, start_us, duration_us)`` of ``steps`` steps
    traced over ``window_s`` seconds of host time."""

    def __init__(self, events: List[Tuple[str, float, float]], window_s: float,
                 steps: int):
        self.events = sorted(events, key=lambda e: e[1])
        self.window_s = window_s
        self.steps = steps

    def _spans(self):
        """The union of the events' intervals, as merged (start, end) µs."""
        out: List[List[float]] = []
        for _, ts, dur in self.events:
            if out and ts <= out[-1][1]:
                out[-1][1] = max(out[-1][1], ts + dur)
            else:
                out.append([ts, ts + dur])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._spans()) / 1e6

    def seconds(self, pred: Callable[[str], bool]) -> float:
        return sum(dur for name, _, dur in self.events if pred(name)) / 1e6

    def group_seconds(self, group: str) -> float:
        return self.seconds(lambda n: kernel_group(n) == group)

    def kernel_seconds(self, name: str) -> float:
        """Device seconds of a hand-written kernel's forward and backward
        launches (``layers.Kernel``): its own kernels, and those it shares
        with another where its own ran and the other's did not."""
        ks = layers.kernels()
        k = next(x for x in ks if x.name == name)
        names = {n for n, _, _ in self.events}

        def ran(x):
            return any(_has(n, x.own) for n in names)
        shared = tuple(f for f in k.shared if ran(k) and not any(
            ran(x) for x in ks if x is not k and f in x.shared))
        return self.seconds(lambda n: _has(n, k.own + shared))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps, each named by the kernel that ran before it."""
        by_name = {}
        for name, _, dur in self.events:
            by_name[name] = by_name.get(name, 0.0) + dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, last_end, last_name = [], None, None
        for name, ts, dur in self.events:
            if last_end is not None and ts > last_end:
                gaps.append((f"after {_short(last_name)}", (ts - last_end) / 1e6))
            if last_end is None or ts + dur >= last_end:
                last_end, last_name = ts + dur, name
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[_short(n), s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def _short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[:n] + "..."


def read_chrome_trace(path: str) -> List[Tuple[str, float, float]]:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def repeat(step: Callable[[], object], n: int) -> int:
    for _ in range(n):
        step()
    return n


def profiled(run_steps: Callable[[], int], sync: Callable[[], None],
             on_card: bool = True) -> Trace:
    """Trace ``run_steps()`` (which returns the number of steps it ran and
    leaves the device's work complete).  Off the card (the harness's
    tests) the host's activity is traced, which has no device events."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    act = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
    with profile(activities=[act]) as prof:
        t0 = time.monotonic()
        steps = run_steps()
        sync()
        window = time.monotonic() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = read_chrome_trace(path)
    return Trace(events, window, steps)
