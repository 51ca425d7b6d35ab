"""Cells on several cards: one process a card, all in one process group.

``run.py`` is rank 0.  It starts one process for every other rank, the
same command with ``--rank`` and ``--port`` added (:func:`start`); each
takes its card (``cuda:<rank>``) and joins the group over TCP on
localhost (:func:`join`: NCCL between cards, gloo for the harness's own
flags, or gloo alone on the CPU in the harness's tests).  Every rank runs
the cell's code in lockstep; rank 0 alone times the window, traces and
prints.  The window's end is rank 0's: after each step it says whether
another follows (:meth:`Group.agree`), so every rank stops on the same
step.

A rank that fails ends the run: rank 0 watches the others
(:func:`supervise`) and, once one has exited with another code than 0,
stops them all and exits with no result; a rank whose parent is gone
exits.  A rank stuck in a collective ends at the group's timeout.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 300  # a collective's longest wait before its rank fails


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(script: str, argv: List[str], world: int, port: int
          ) -> List[subprocess.Popen]:
    """Ranks 1 .. world - 1 of ``script``, their standard output sent to
    standard error (only rank 0's result is the run's)."""
    return [subprocess.Popen([sys.executable, script, *argv, "--rank", str(r),
                              "--port", str(port)], stdout=sys.stderr.fileno())
            for r in range(1, world)]


def stop(procs: List[subprocess.Popen]) -> None:
    """End every rank still running and wait for each."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def supervise(procs: List[subprocess.Popen], limit_s: float,
              poll_s: float = 0.5) -> threading.Thread:
    """A thread that ends this process (exit 1, no result) once a rank has
    exited with another code than 0 or ``limit_s`` has passed, after
    stopping every rank."""
    deadline = time.monotonic() + limit_s

    def watch():
        while True:
            bad = [(i + 1, p.returncode) for i, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            late = time.monotonic() > deadline
            if bad or late:
                why = f"rank(s) exited {bad}" if bad else \
                    f"the run passed its {limit_s:.0f} s"
                print(f"portbench: {why}; stopping every rank",
                      file=sys.stderr, flush=True)
                stop(procs)
                os._exit(1)
            if all(p.returncode == 0 for p in procs):
                return
            time.sleep(poll_s)
    t = threading.Thread(target=watch, daemon=True)
    t.start()
    return t


def orphan_guard(poll_s: float = 1.0) -> None:
    """End this rank once the process that started it is gone."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(poll_s)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


class Group:
    """This process's place in the group: ``rank`` of ``world``, its
    ``device``, and the gloo group for the harness's flags (``control``)."""

    def __init__(self, rank: int, world: int, device, control=None):
        self.rank, self.world, self.device = rank, world, device
        self.control = control

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        t = torch.tensor([int(flag)])
        dist.broadcast(t, 0, group=self.control)
        return bool(t[0])

    def max(self, x: int) -> int:
        t = torch.tensor([x], dtype=torch.int64)
        dist.all_reduce(t, dist.ReduceOp.MAX, group=self.control)
        return int(t[0])

    def gather(self, obj) -> Optional[list]:
        """Every rank's ``obj`` on rank 0 (None elsewhere)."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, 0, group=self.control)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.control)


def join(rank: int, world: int, port: int, device_type: str = "cuda") -> Group:
    """Join the group as ``rank``; on cards with NCCL, on the CPU with
    gloo."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
        timeout=timedelta(seconds=TIMEOUT_S))
    control = dist.new_group(backend="gloo") if device_type == "cuda" else None
    return Group(rank, world, device, control)


def leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
