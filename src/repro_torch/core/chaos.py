"""Seeded fault injection for the broker/worker tier (the chaos harness).

Robustness claims — retry budgets, dead-lettering, lease redelivery,
exactly-once completion — are only as good as the failure paths they have
actually been driven through.  This module makes those paths cheap to
exercise deterministically:

* :class:`ChaosBroker` wraps any :class:`~repro_torch.core.queue.Broker` and
  injects faults on the data-plane operations (put/get/ack/nack and
  their batch variants) from a seeded RNG:

  - ``p_error``  — raise :class:`BrokerUnavailable` instead of the op
    (the transient-outage path: worker backoff, netbroker retry).
  - ``p_delay`` / ``max_delay_s`` — sleep before the op (slow broker;
    stretches lease windows and ack flushes).
  - ``p_drop_ack`` — perform *nothing* but report ack success (a lost
    ack: the lease expires and the task is redelivered, so completion
    must be idempotent under re-execution).
  - ``p_lose_lease`` — claim a lease from the inner broker but withhold
    it from the caller (a worker that died mid-lease: the task comes
    back after the visibility timeout).

  ``partition(seconds)`` opens a window during which every data-plane
  op raises :class:`BrokerUnavailable` (a network partition); ``heal()``
  closes it early.  Control-plane reads (qsize, queue_names, idle,
  stats, ...) pass through untouched so drain loops and assertions stay
  usable mid-chaos.

* :class:`FlakyFn` wraps a registered step fn with seeded, *bounded*
  failures per bundle key — each (study, lo, hi) fails at most
  ``max_failures`` times, so any retry budget >= ``max_failures``
  eventually succeeds and the test can still assert full completion.

Every injected fault is counted in :attr:`ChaosBroker.faults`; tests
assert the run actually suffered (non-zero injections) before claiming
the audit means anything.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.queue import Broker, BrokerUnavailable, Lease, Task


class ChaosBroker:
    """A fault-injecting proxy around any Broker (seeded, thread-safe)."""

    def __init__(self, inner: Broker, seed: int = 0,
                 p_error: float = 0.0, p_delay: float = 0.0,
                 max_delay_s: float = 0.05, p_drop_ack: float = 0.0,
                 p_lose_lease: float = 0.0):
        self.inner = inner
        self.rng = random.Random(seed)
        self.p_error = p_error
        self.p_delay = p_delay
        self.max_delay_s = max_delay_s
        self.p_drop_ack = p_drop_ack
        self.p_lose_lease = p_lose_lease
        self._lock = threading.Lock()
        self._partition_until = 0.0
        self.faults: Dict[str, int] = {
            "errors": 0, "delays": 0, "dropped_acks": 0,
            "lost_leases": 0, "partition_rejections": 0,
        }

    # -- fault controls ------------------------------------------------------
    def partition(self, seconds: float) -> None:
        """Open a partition window: all data-plane ops fail for its span."""
        with self._lock:
            self._partition_until = max(self._partition_until,
                                        time.monotonic() + seconds)

    def heal(self) -> None:
        with self._lock:
            self._partition_until = 0.0

    def _roll(self, p: float) -> bool:
        return p > 0 and self.rng.random() < p

    def _preamble(self, op: str) -> None:
        """Partition check + error/delay rolls shared by every data op."""
        with self._lock:
            if time.monotonic() < self._partition_until:
                self.faults["partition_rejections"] += 1
                raise BrokerUnavailable(
                    f"chaos: partitioned (op={op})")
            if self._roll(self.p_error):
                self.faults["errors"] += 1
                raise BrokerUnavailable(f"chaos: injected error (op={op})")
            delay = (self.rng.random() * self.max_delay_s
                     if self._roll(self.p_delay) else 0.0)
            if delay > 0:
                self.faults["delays"] += 1
        if delay > 0:
            time.sleep(delay)

    # -- data plane (faults injected) ----------------------------------------
    def put(self, task: Task) -> None:
        self._preamble("put")
        self.inner.put(task)

    def put_many(self, tasks: List[Task]) -> None:
        self._preamble("put_many")
        self.inner.put_many(tasks)

    def get(self, timeout: Optional[float] = 0.0,
            queues: Optional[Sequence[str]] = None) -> Optional[Lease]:
        self._preamble("get")
        lease = self.inner.get(timeout, queues)
        if lease is not None:
            with self._lock:
                if self._roll(self.p_lose_lease):
                    self.faults["lost_leases"] += 1
                    return None  # leased but never delivered -> vt redelivery
        return lease

    def get_many(self, n: int, timeout: Optional[float] = 0.0,
                 queues: Optional[Sequence[str]] = None) -> List[Lease]:
        self._preamble("get_many")
        leases = self.inner.get_many(n, timeout, queues)
        if leases:
            with self._lock:
                kept = []
                for lease in leases:
                    if self._roll(self.p_lose_lease):
                        self.faults["lost_leases"] += 1
                    else:
                        kept.append(lease)
            return kept
        return leases

    def ack(self, tag: str) -> None:
        self._preamble("ack")
        with self._lock:
            if self._roll(self.p_drop_ack):
                self.faults["dropped_acks"] += 1
                return  # pretend success; lease expires -> redelivery
        self.inner.ack(tag)

    def ack_many(self, tags: Iterable[str]) -> None:
        self._preamble("ack_many")
        tags = list(tags)
        with self._lock:
            kept = []
            for t in tags:
                if self._roll(self.p_drop_ack):
                    self.faults["dropped_acks"] += 1
                else:
                    kept.append(t)
        if kept:
            self.inner.ack_many(kept)

    def nack(self, tag: str) -> None:
        self._preamble("nack")
        self.inner.nack(tag)

    # -- control plane (clean passthrough) -----------------------------------
    def qsize(self, queues: Optional[Sequence[str]] = None) -> int:
        return self.inner.qsize(queues)

    def queue_names(self) -> List[str]:
        return self.inner.queue_names()

    def inflight(self) -> int:
        return self.inner.inflight()

    def inflight_tasks(self) -> List[Tuple[Task, float]]:
        return self.inner.inflight_tasks()

    def idle(self) -> bool:
        return self.inner.idle()

    def set_visibility_timeout(self, queue: str, timeout: float) -> None:
        self.inner.set_visibility_timeout(queue, timeout)

    def set_max_queue_depth(self, queue: str, depth: Optional[int]) -> None:
        self.inner.set_max_queue_depth(queue, depth)

    def heartbeat(self, consumer_id: str,
                  queues: Optional[Sequence[str]] = None) -> None:
        self.inner.heartbeat(consumer_id, queues)

    # migration protocol ops are control-plane: chaos must not break the
    # handoff itself, only the data traffic flowing around it
    def migrate_queue(self, queue: str, target: Optional[str]) -> None:
        self.inner.migrate_queue(queue, target)

    def export_queue(self, queue: str, max_n: int = 256) -> List[Dict[str, Any]]:
        return self.inner.export_queue(queue, max_n)

    def import_tasks(self, tasks: List[Dict[str, Any]]) -> None:
        self.inner.import_tasks(tasks)

    @property
    def stats(self) -> Dict[str, Any]:
        s = dict(self.inner.stats)
        with self._lock:
            s["chaos"] = dict(self.faults)
        return s

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()


class FlakyFn:
    """Wrap a step fn with seeded, bounded failures per bundle.

    Each (study, lo, hi) key fails at most ``max_failures`` times before
    the underlying fn runs, so a retry budget >= ``max_failures``
    guarantees eventual completion — the chaos suite can assert both
    "failures happened" and "everything still finished".
    """

    def __init__(self, fn, p_fail: float = 0.3, max_failures: int = 2,
                 seed: int = 0):
        self.fn = fn
        self.p_fail = p_fail
        self.max_failures = max_failures
        self.rng = random.Random(seed)
        self.failed: Dict[Tuple[str, int, int], int] = {}
        self.injected = 0
        self._lock = threading.Lock()

    def __call__(self, ctx) -> None:
        key = (ctx.study, int(ctx.lo), int(ctx.hi))
        with self._lock:
            n = self.failed.get(key, 0)
            fail = (n < self.max_failures
                    and self.rng.random() < self.p_fail)
            if fail:
                self.failed[key] = n + 1
                self.injected += 1
        if fail:
            raise RuntimeError(
                f"chaos: injected fn failure #{n + 1} for {key}")
        self.fn(ctx)
