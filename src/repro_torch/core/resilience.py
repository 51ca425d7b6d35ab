"""Resilience: crawl-and-resubmit, retry policy, straggler mitigation.

Paper Sec. 3.1: the 100M-simulation run initially completed ~70% (node and
filesystem failures); a pass that crawled the directory tree and resubmitted
missing simulations to the Rabbit queue raised it to 85%, a final pass to
99.755%.  ``crawl_and_resubmit`` is that pass: diff the bundler's on-disk
truth against the expected index space and enqueue only the missing ranges
(at real-task priority — recovery work drains first).

Straggler mitigation: ``SpeculativeReissuer`` duplicates tasks that have
been in flight longer than ``dup_after`` (the backup-task trick); the
runtime's once-markers make duplicated execution a no-op, so first-finisher
wins without coordination.

All of this works against ANY Broker — including a remote NetBroker: the
crawler only needs ``put`` and the reissuer uses the protocol's
``inflight_tasks()`` snapshot instead of poking backend internals, so the
recovery pass can run from a machine that shares neither the queue
directory nor the broker process.

``CursorCrawler`` is the incremental variant of ``crawl_and_resubmit``: it
delta-reads the archive via ``Bundler.load_since(cursor)`` so a sweep costs
only the bundles that appeared since the previous sweep, not a full
re-walk + decompress of the tree.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Dict, Optional, Set, Tuple

from repro_torch.core.bundler import Bundler, missing_samples
from repro_torch.core.queue import (PRIORITY_REAL, BrokerUnavailable, Task,
                              new_task)


@dataclasses.dataclass
class RetryPolicy:
    max_retries: int = 3
    backoff_s: float = 0.0

    def should_retry(self, task: Task) -> bool:
        return task.retries < self.max_retries


@dataclasses.dataclass
class BackoffPolicy:
    """Jittered exponential backoff: ``delay(attempt)`` for attempt 0, 1, ...

    ``base * multiplier**attempt`` capped at ``cap``, then multiplied by a
    uniform factor in ``[1 - jitter, 1]`` so a fleet of workers that failed
    together doesn't retry in lockstep.  The one home for retry cadence —
    worker broker-error loops and NetBroker reconnects both use it instead
    of hand-rolled constants.
    """
    base: float = 0.05
    cap: float = 1.0
    multiplier: float = 2.0
    jitter: float = 0.25
    rng: Optional[random.Random] = None

    def delay(self, attempt: int) -> float:
        d = min(self.cap, self.base * self.multiplier ** max(0, attempt))
        if self.jitter > 0:
            r = self.rng.random() if self.rng is not None else random.random()
            d *= 1.0 - self.jitter * r
        return d


class CircuitBreaker:
    """Per-endpoint circuit breaker: closed → open → half-open.

    ``failure_threshold`` consecutive hard failures open the circuit;
    while open, ``allow()`` returns False (callers fail fast instead of
    burning their full reconnect window against a dead endpoint).  After
    ``reset_timeout`` seconds one probe call is let through (half-open):
    its ``record_success`` closes the circuit, its ``record_failure``
    re-opens it for another window.  Thread-safe.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 3,
                 reset_timeout: float = 1.0):
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout = reset_timeout
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if self._state == self.OPEN and \
                time.monotonic() - self._opened_at >= self.reset_timeout:
            self._state = self.HALF_OPEN

    def allow(self) -> bool:
        """May a call proceed right now?  In half-open, lets probes through
        (their outcome decides whether the circuit closes or re-opens)."""
        with self._lock:
            self._maybe_half_open()
            return self._state != self.OPEN

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            self._maybe_half_open()
            if self._state == self.HALF_OPEN:
                self._state = self.OPEN
                self._opened_at = time.monotonic()
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._state = self.OPEN
                self._opened_at = time.monotonic()


def crawl_and_resubmit(bundler: Bundler, expected_n: int, broker,
                       task_template: dict, bundle: int,
                       queue: Optional[str] = None) -> Tuple[int, int]:
    """Diff disk vs expectation; enqueue missing ranges. Returns
    (n_missing_samples, n_tasks_enqueued).

    Recovery tasks are routed onto the study's real-task queue (from the
    template's ``real_queue`` key unless ``queue`` overrides it), so a
    deployment whose simulation workers subscribe to a named queue actually
    receives the resubmissions.
    """
    if queue is None:
        queue = task_template.get("real_queue", "default")
    present, corrupt = bundler.crawl()
    # corrupt files count as missing: drop their ids
    for path in corrupt:
        pass  # ids unreadable; covered by the expected-set diff below
    ranges = missing_samples(expected_n, present)
    return (sum(hi - lo for lo, hi in ranges),
            _enqueue_ranges(broker, ranges, task_template, bundle, queue))


def _iter_bundle_chunks(ranges, bundle: int):
    """Split [lo, hi) ranges into (s, e) chunks — the ONE place chunking
    lives, so resubmission granularity (and CursorCrawler's cooldown keys)
    can never diverge from what gets enqueued.

    Chunk boundaries snap to the absolute ``bundle`` grid (matching the
    hierarchy's leaf layout) rather than running from each range's lo:
    grid chunks are STABLE as a hole shrinks from either end, so the
    crawler's per-chunk cooldown keys keep matching across sweeps instead
    of being reminted every time part of a range completes."""
    for lo, hi in ranges:
        s = lo
        while s < hi:
            e = min(hi, (s // bundle + 1) * bundle)
            yield s, e
            s = e


def _enqueue_ranges(broker, ranges, task_template: dict, bundle: int,
                    queue: str) -> int:
    """Enqueue missing ranges as bundle-sized real tasks (bundle-sized so
    redelivery granularity is unchanged)."""
    n_tasks = 0
    for s, e in _iter_bundle_chunks(ranges, bundle):
        broker.put(new_task("real", {**task_template, "samples": [s, e]},
                            priority=PRIORITY_REAL, queue=queue))
        n_tasks += 1
    return n_tasks


class CursorCrawler:
    """Incremental crawl-and-resubmit for a long-running recovery loop.

    ``crawl_and_resubmit`` re-walks and re-reads the whole archive on every
    call — fine for a one-shot pass, quadratic for a periodic sweeper.
    This crawler holds a ``Bundler.load_since`` cursor: each ``sweep()``
    decompresses only bundles that appeared since the last sweep, folds
    their sample ids into the running ``present`` set, and enqueues what is
    still missing.

    A range already resubmitted is not re-enqueued until it has stayed
    missing for ``resubmit_after`` further sweeps (duplicates are *safe* —
    once-markers — just wasteful).
    """

    def __init__(self, bundler: Bundler, expected_n: int,
                 resubmit_after: int = 2):
        self.bundler = bundler
        self.expected_n = expected_n
        self.resubmit_after = max(1, resubmit_after)
        self._cursor = None
        self._present: Set[int] = set()
        self._submitted: Dict[Tuple[int, int], int] = {}
        self._sweep_i = 0

    @property
    def present(self) -> Set[int]:
        return set(self._present)

    def sweep(self, broker, task_template: dict, bundle: int,
              queue: Optional[str] = None) -> Tuple[int, int]:
        """Delta-read the archive, resubmit missing ranges.

        Returns ``(n_missing_samples, n_tasks_enqueued)``."""
        self._sweep_i += 1
        data, self._cursor = self.bundler.load_since(self._cursor)
        ids = data.get("_sample_ids")
        if ids is not None:
            self._present.update(int(i) for i in ids)
        ranges = missing_samples(self.expected_n, self._present)
        n_missing = sum(hi - lo for lo, hi in ranges)
        if queue is None:
            queue = task_template.get("real_queue", "default")
        n_tasks = 0
        still_missing: Dict[Tuple[int, int], int] = {}
        for s, e in _iter_bundle_chunks(ranges, bundle):
            last = self._submitted.get((s, e))
            if last is None or self._sweep_i - last >= self.resubmit_after:
                broker.put(new_task(
                    "real", {**task_template, "samples": [s, e]},
                    priority=PRIORITY_REAL, queue=queue))
                last = self._sweep_i
                n_tasks += 1
            still_missing[(s, e)] = last
        # completed chunks never go missing again (present only grows):
        # keeping only still-missing keys bounds the cooldown map
        self._submitted = still_missing
        return n_missing, n_tasks


class SpeculativeReissuer:
    """Duplicate-issue tasks stuck in flight (straggler mitigation).

    Uses the Broker protocol's ``inflight_tasks()`` snapshot, so it works
    identically against every backend — including a remote NetBroker.
    Execution idempotency (runtime once-markers) makes duplicates safe.
    """

    def __init__(self, broker, dup_after: float = 5.0, max_dups: int = 1):
        self.broker = broker
        self.dup_after = dup_after
        self.max_dups = max_dups
        self._dups: dict = {}

    def scan_once(self) -> int:
        try:
            items = self.broker.inflight_tasks()
        except BrokerUnavailable:
            return 0  # broker briefly down: reissue on the next scan
        n = 0
        for task, age in items:
            if age > self.dup_after and \
                    self._dups.get(task.id, 0) < self.max_dups:
                dup = new_task(task.kind, dict(task.payload),
                               priority=task.priority, queue=task.queue)
                self.broker.put(dup)
                self._dups[task.id] = self._dups.get(task.id, 0) + 1
                n += 1
        return n
