"""The hierarchical task-generation algorithm (paper Sec. 2.2, Fig. 2).

``merlin run`` enqueues ONE root generation task holding only the metadata
needed to create its children; consumers recursively expand the bounded-
fanout tree until the leaves — the real sample bundles — are enqueued.
Because real tasks outrank generation tasks (PRIORITY_REAL < PRIORITY_GEN,
lower drains first — the paper prioritizes *draining* the queue over
*filling* it), the queue self-throttles: simulations start as soon as the
first leaf exists (Fig. 4) and the server never holds more than
O(fanout · depth · workers) undone generation messages (the "server
stability" property of Sec. 2.2).

The same index-space hierarchy is reused on-device: a leaf's [start, stop)
range becomes the batch slice of a vmapped simulator bundle
(core/ensemble.py) — the TPU adaptation documented in DESIGN.md.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, List, Tuple

from repro_torch.core.queue import PRIORITY_GEN, PRIORITY_REAL, Task, new_task


@dataclasses.dataclass(frozen=True)
class HierarchyCfg:
    max_fanout: int = 16      # max children per generation task
    bundle: int = 1           # samples per leaf (real) task


def depth_for(n_leaves: int, fanout: int) -> int:
    if n_leaves <= 1:
        return 0
    return max(1, math.ceil(math.log(n_leaves, fanout)))


def n_gen_tasks(n_samples: int, cfg: HierarchyCfg) -> int:
    """Total generation (non-leaf) tasks the hierarchy will create."""
    leaves = math.ceil(n_samples / cfg.bundle)
    total = 0
    level = leaves
    while level > 1:
        level = math.ceil(level / cfg.max_fanout)
        total += level
    return max(total, 1 if leaves > 1 else 0)


def _queues(payload: dict) -> Tuple[str, str]:
    """Named-queue routing carried in the payload (set by the runtime).

    ``real_queue``/``gen_queue`` keys propagate through every level of the
    hierarchy so leaves land on the simulation queue and interior generator
    tasks on the generation queue (paper Sec. 2.2 routing-key semantics).
    """
    return (payload.get("real_queue", "default"),
            payload.get("gen_queue", "default"))


def root_task(study: str, step: str, n_samples: int, cfg: HierarchyCfg,
              extra: dict | None = None) -> Task:
    """The single message `merlin run` sends (metadata only)."""
    payload = {"study": study, "step": step, "lo": 0, "hi": n_samples,
               "fanout": cfg.max_fanout, "bundle": cfg.bundle,
               **(extra or {})}
    real_q, gen_q = _queues(payload)
    n_leaves = math.ceil(n_samples / cfg.bundle)
    if n_leaves <= 1:
        return new_task("real", {**payload, "samples": [0, n_samples]},
                        priority=PRIORITY_REAL, queue=real_q)
    return new_task("gen", payload, priority=PRIORITY_GEN, queue=gen_q)


def expand(task: Task) -> List[Task]:
    """Expand one generation task into its children (executed by a worker).

    Children covering more than one bundle are generation tasks; children
    covering a single bundle are real tasks.
    """
    p = task.payload
    lo, hi, fanout, bundle = p["lo"], p["hi"], p["fanout"], p["bundle"]
    real_q, gen_q = _queues(p)
    n_leaves = math.ceil((hi - lo) / bundle)
    extra = {k: v for k, v in p.items()
             if k not in ("lo", "hi", "fanout", "bundle", "samples")}
    children: List[Task] = []
    if n_leaves <= fanout:
        # bottom of the tree: enqueue the real sample bundles
        for i in range(n_leaves):
            s_lo = lo + i * bundle
            s_hi = min(lo + (i + 1) * bundle, hi)
            children.append(new_task(
                "real", {**extra, "fanout": fanout, "bundle": bundle,
                         "samples": [s_lo, s_hi]},
                priority=PRIORITY_REAL, queue=real_q))
        return children
    # split into <= fanout contiguous child ranges, each spanning a whole
    # power-of-fanout number of leaves: children at every level then carry
    # full fanout-sized subtrees (bottom generators emit `fanout` real
    # tasks), keeping total generation-task count ~ n_leaves/(fanout-1) —
    # the paper's "hierarchical grouping of multiple levels" (Fig. 2).
    # Integer arithmetic: float log rounds up on exact powers, which would
    # make leaves_per_child == n_leaves (a self-identical child -> loop).
    leaves_per_child = 1
    while leaves_per_child * fanout < n_leaves:
        leaves_per_child *= fanout
    span = leaves_per_child * bundle
    start = lo
    while start < hi:
        stop = min(start + span, hi)
        children.append(new_task(
            "gen", {**extra, "lo": start, "hi": stop, "fanout": fanout,
                    "bundle": bundle},
            priority=PRIORITY_GEN, queue=gen_q))
        start = stop
    return children


def iter_leaves(n_samples: int, cfg: HierarchyCfg) -> Iterator[Tuple[int, int]]:
    """All leaf (lo, hi) sample ranges, in order (for verification/crawling)."""
    for i in range(math.ceil(n_samples / cfg.bundle)):
        yield i * cfg.bundle, min((i + 1) * cfg.bundle, n_samples)
