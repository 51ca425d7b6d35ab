"""Task brokers: the Celery/RabbitMQ stand-in (DESIGN.md mapping C1).

Routing semantics (paper Sec. 2.2-3.1):

* **Named queues.** Every :class:`Task` carries a ``queue`` name and is
  delivered *only* to consumers subscribed to that queue — the analogue of
  RabbitMQ routing keys, which is how the paper pins simulation workers and
  ML workers to disjoint work streams.  ``get(queues=None)`` subscribes to
  every queue; ``get(queues=("sims",))`` sees only ``sims`` tasks.
* **Priorities across queues.** Within a consumer's subscription, tasks are
  delivered in global ``(priority, enqueue-sequence)`` order: real
  simulation tasks (PRIORITY_REAL) drain before task-generation tasks
  (PRIORITY_GEN) even when they live in different queues — the paper's
  server-stability property (drain the queue before filling it).
* **Leases.** A claim is a lease with a visibility timeout: a worker that
  dies mid-task never acks, the lease expires, and the task is redelivered
  with ``task.retries`` incremented — identically in both backends, so
  retry caps (core/resilience.py) behave the same everywhere.  Delivery is
  at-least-once; execution idempotency is the runtime's job (once-markers).
* **Batched operations.** ``get_many``/``ack_many``/``put_many`` amortize
  lock/filesystem round-trips for high-throughput draining
  (benchmarks/broker_throughput.py).

The interface is the formal :class:`Broker` protocol below.  Three
implementations:

* :class:`InMemoryBroker` — thread-safe, condition-variable based (no
  polling slices), per-queue binary heaps; for in-process worker pools and
  the performance benchmarks (Figs. 3-6 analogues).
* :class:`FileBroker` — directory-backed, multiprocess-safe via atomic
  renames (claim = rename into ``claimed/``), one subdirectory per named
  queue, and a cached in-memory index keyed by ``(priority, seq)`` so the
  claim hot path does NOT re-list + re-sort the directory per task.
  Independent worker *processes* ("batch allocations") can attach to a
  shared queue directory — the surge-computing model of Sec. 3.
* :class:`repro_torch.core.netbroker.NetBroker` — a TCP client speaking to a
  :class:`repro_torch.core.netbroker.BrokerServer` fronting either backend above:
  allocations on *different nodes* coordinate with no shared filesystem at
  all, the paper's actual RabbitMQ deployment model.
* :class:`repro_torch.core.shardbroker.ShardedBroker` — the federation layer:
  the full protocol over N endpoints, each *queue* routed to one shard by
  stable hash, for when ensemble throughput outgrows one broker process.

Cross-cutting policies, identical in every backend:

* **Per-queue visibility timeouts** (``queue_timeouts=`` /
  ``set_visibility_timeout``): a long-running simulation queue and a fast
  generation queue no longer share one lease clock.
* **Fairness** (``fairness="weighted"``, ``queue_weights=``): optional
  weighted round-robin across the subscribed queues so one flooding queue
  cannot starve the others; strict global priority stays the default.
  ``stats["starvation_avoided"]`` counts deliveries where fairness picked a
  different queue than strict priority would have.
* **Backpressure** (``max_queue_depth=``, ``put_timeout=``): producers
  against a full queue block until it drains, then get a typed
  :class:`BrokerFull`; redelivery is exempt so recovery never wedges.
  Workers throttle generation-task expansion on it instead of dying.
  ``queue_depths=`` / ``set_max_queue_depth(queue, depth)`` override the
  bound per named queue (``depth=None`` clears an override back to the
  global bound) — a flood-prone generation queue can be clamped tight
  while the simulation queue stays deep.  FileBroker persists overrides
  to ``<root>/.depth.json`` (like ``.vt.json``) so every instance on the
  directory honors them; NetBroker relays the op, and ShardedBroker
  routes it to the queue's owning shard.
* **Consumer heartbeats** (``heartbeat(consumer_id, queues)``,
  ``heartbeat_ttl=``): ``stats["consumers"]`` is a live per-queue
  consumer count instead of a connection-count guess — the basis for
  "are there any workers on the sims queue?" operational checks.
* **Queue-name validation**: enforced once, at :class:`Task` creation
  (``validate_queue_name``), so a name FileBroker cannot store fails
  identically and immediately on every backend.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import json
import os
import threading
import time
import uuid
from typing import (Any, Dict, Iterable, List, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

from repro_torch.core import jsonstore


class BrokerError(RuntimeError):
    """A broker operation failed (bad request, protocol violation)."""


class BrokerUnavailable(BrokerError, ConnectionError):
    """The broker cannot be reached (remote down / unreachable).

    Raised by :class:`repro_torch.core.netbroker.NetBroker` after its reconnect
    window is exhausted; consumers (core/worker.py) treat it as transient
    and keep polling so a restarted broker server is picked back up."""


class BrokerFull(BrokerError):
    """Backpressure: a put could not complete within ``put_timeout``
    because the target queue is at ``max_queue_depth``.

    ``put``/``put_many`` block first and raise only at the deadline;
    ``put_timeout`` bounds the TOTAL blocking time of one call (not one
    stall), so a server-side put relayed by a BrokerServer can never park
    a handler thread longer than ``put_timeout`` — keep it below the
    clients' ``request_grace`` (10 s) and a blocked put always surfaces
    as this typed error, never as a socket timeout.  In a ``put_many``
    the tasks admitted before the raise ARE enqueued (delivery is
    at-least-once, so retrying is safe — duplicates no-op on the
    runtime's once-markers; retry in bounded chunks, as the worker's gen
    expansion does, so re-sent prefixes stay small).  Producers should
    throttle and retry, never treat this as fatal."""


class StaleEpochError(BrokerError):
    """An ack/nack carried a lease tag minted under a superseded shard
    epoch (the tag's primary died and ownership failed over).  The old
    primary's leases are fenced: the operation is rejected so a zombie
    cannot complete work the new primary has already redelivered."""


def validate_queue_name(queue: str) -> str:
    """The ONE queue-name rule, enforced at Task creation for every backend.

    ``__`` is the FileBroker claim-file field separator, ``/`` would escape
    the queue directory, and a leading ``.`` collides with temp/hidden
    files — but a name must fail identically on InMemoryBroker/NetBroker
    too, or the same study spec runs on ``mem://`` and crashes mid-run the
    first time it is pointed at ``file://`` (or poisons one shard of a
    federation late in a run)."""
    if not queue or "__" in queue or "/" in queue or queue.startswith("."):
        raise ValueError(
            f"invalid queue name {queue!r}: must be non-empty and contain "
            "no '__' or '/', and not start with '.'")
    return queue

# priorities: lower = served first.  Real work drains before generation work.
PRIORITY_REAL = 0
PRIORITY_GEN = 1
PRIORITY_LOW = 2

# --- dead-letter queues ------------------------------------------------------
# A task whose step policy is ``on_failure: dead_letter`` moves, at retry
# exhaustion, to ``dlq.<original queue>`` on the SAME broker.  DLQ queues are
# ordinary queues for explicit addressing (merlin-dlq lists/inspects/requeues
# them over any broker URL) but are EXCLUDED from wildcard subscriptions,
# wildcard qsize, and idle() — otherwise any ``queues=None`` worker would
# re-execute dead letters forever and a drain would wedge on them.
DLQ_PREFIX = "dlq."


def dlq_queue_name(queue: str) -> str:
    return queue if is_dlq(queue) else DLQ_PREFIX + queue


def is_dlq(queue: str) -> bool:
    return queue.startswith(DLQ_PREFIX)


def original_queue(queue: str) -> str:
    return queue[len(DLQ_PREFIX):] if is_dlq(queue) else queue


@dataclasses.dataclass
class Task:
    id: str
    kind: str  # "gen" | "real" | "step" | custom
    payload: Dict[str, Any]
    priority: int = PRIORITY_REAL
    queue: str = "default"
    retries: int = 0
    enqueued_at: float = 0.0

    def __post_init__(self) -> None:
        # every construction path — new_task, from_json, the wire layer's
        # Task(**d) — funnels through here, so a bad queue name fails at
        # task creation in EVERY backend, not at FileBroker's first put
        validate_queue_name(self.queue)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "Task":
        return Task(**json.loads(s))


_TASK_FIELDS = tuple(f.name for f in dataclasses.fields(Task))


def task_to_wire(task: "Task") -> Dict[str, Any]:
    """Shallow task -> dict for immediate serialization.

    ``dataclasses.asdict`` recursively *deep-copies* every payload value
    (~0.5 ms per task at 512 payload floats — it dominated the broker
    wire hot path, dwarfing both codecs).  Encoders only read the tree,
    so sharing the payload references is safe; use this everywhere a
    task dict goes straight into a codec.
    """
    return {f: getattr(task, f) for f in _TASK_FIELDS}


# -- FileBroker task-file format ---------------------------------------------
# v1 is Task.to_json() text (first byte "{", readable forever); v2 is one
# format-version byte \x02 followed by the bin1 binary encoding of the
# task dict (core/wirecodec.py) — payloads dominated by float arrays skip
# text float formatting/parsing entirely.  Readers sniff the first byte,
# so directories mixing formats (rolling upgrade, old producers) just work.
TASK_FILE_V2_MAGIC = b"\x02"
_TASK_FORMATS = ("auto", "json", "binary")
_BIG_FLOAT_FIELD = 16  # floats; shorter lists aren't worth the binary path


def _has_big_float_field(obj: Any, depth: int = 0) -> bool:
    """Does this payload contain a float list long enough that binary
    array encoding pays?  Cheap structural sniff, not a full scan."""
    if depth > 4:
        return False
    if isinstance(obj, list):
        if len(obj) >= _BIG_FLOAT_FIELD and isinstance(obj[0], float):
            return True
        return any(_has_big_float_field(v, depth + 1) for v in obj[:32])
    if isinstance(obj, dict):
        return any(_has_big_float_field(v, depth + 1) for v in obj.values())
    # ndarray payloads (duck-typed: queue.py stays numpy-free) always
    # take the binary path — Task.to_json can't carry them at all
    return hasattr(obj, "dtype") and getattr(obj, "size", 0) > 0


def encode_task_file(task: "Task", fmt: str = "auto") -> bytes:
    """Serialize a task for a FileBroker task file.

    ``auto`` picks v2 binary only when the payload carries large numeric
    fields (everything else stays greppable JSON text); ``json`` forces
    v1 (what pre-v2 readers understand); ``binary`` forces v2.
    """
    if fmt == "binary" or (fmt == "auto"
                           and _has_big_float_field(task.payload)):
        from repro_torch.core.wirecodec import BIN_CODEC
        return TASK_FILE_V2_MAGIC + BIN_CODEC.encode(task_to_wire(task))
    return task.to_json().encode("utf-8")


def decode_task_file(data: bytes) -> "Task":
    """Parse either task-file format (first-byte sniff)."""
    if data[:1] == TASK_FILE_V2_MAGIC:
        from repro_torch.core.wirecodec import BIN_CODEC
        doc = BIN_CODEC.decode(data[1:])
        if not isinstance(doc, dict):
            raise ValueError("task file v2 does not hold a task object")
        return Task(**doc)
    return Task.from_json(data.decode("utf-8"))


# fast process-unique task ids: one random prefix + a counter.  uuid4 per
# task costs ~1.5us (os.urandom) and dominated hierarchy expansion at
# >1e5 tasks/s (§Perf host-side log in EXPERIMENTS.md).
_ID_PREFIX = uuid.uuid4().hex[:10]
_ID_SEQ = itertools.count()


def new_task(kind: str, payload: Dict[str, Any], *, priority: int = PRIORITY_REAL,
             queue: str = "default") -> Task:
    return Task(id=f"{_ID_PREFIX}{next(_ID_SEQ):011x}", kind=kind,
                payload=payload, priority=priority, queue=queue)


@dataclasses.dataclass
class Lease:
    task: Task
    tag: str


def _normalize_queues(queues) -> Optional[Tuple[str, ...]]:
    """None = all queues; a string is a single-queue subscription."""
    if queues is None:
        return None
    if isinstance(queues, str):
        return (queues,)
    return tuple(queues)


@runtime_checkable
class Broker(Protocol):
    """The formal broker contract every backend implements.

    Semantics (shared by InMemoryBroker, FileBroker, and NetBroker):

    * ``put``/``put_many`` enqueue; delivery is at-least-once, so producers
      may safely retry (execution idempotency is the runtime's job).
    * ``get``/``get_many(queues=...)`` claim leases from the subscribed
      queues (``None`` = all, a string = one queue), blocking up to
      ``timeout`` (``None`` = forever) for the *first* task only.
    * ``ack``/``ack_many`` complete a lease; acking an unknown or already
      acked tag is a **no-op** (idempotent — required for safe client
      retries over a network).
    * ``nack`` returns a lease to its queue immediately with
      ``task.retries`` incremented; an unacked lease does the same on its
      own once its queue's visibility timeout expires.
    * ``qsize``/``queue_names``/``inflight``/``idle`` introspect;
      ``stats`` is a dict of monotonic counters (``enqueued``, ``acked``,
      ``redelivered``, ``starvation_avoided``, ...) plus ``consumers``:
      a ``{queue: live-consumer-count}`` view built from heartbeats.
    * ``put``/``put_many`` against a queue at ``max_queue_depth`` block up
      to ``put_timeout`` then raise :class:`BrokerFull` (backpressure);
      redelivery (nack / lease expiry) is exempt so recovery never wedges.
      ``set_max_queue_depth(queue, depth)`` overrides the bound for one
      named queue (``None`` clears the override).
    * ``heartbeat(consumer_id, queues)`` registers/refreshes a consumer's
      subscription; entries older than the backend's ``heartbeat_ttl`` are
      dropped, so ``stats["consumers"]`` reports *live* consumers per
      queue instead of guessing from connection counts.  A ``None``
      subscription (all queues) is reported under ``"*"``.
    * ``set_visibility_timeout(queue, t)`` overrides the lease clock for
      one named queue; ``inflight_tasks()`` snapshots leased tasks with
      their lease ages (straggler reissue, core/resilience.py).
    """

    stats: Dict[str, Any]

    def put(self, task: Task) -> None: ...
    def put_many(self, tasks: List[Task]) -> None: ...
    def get(self, timeout: Optional[float] = 0.0,
            queues: Optional[Sequence[str]] = None) -> Optional[Lease]: ...
    def get_many(self, n: int, timeout: Optional[float] = 0.0,
                 queues: Optional[Sequence[str]] = None) -> List[Lease]: ...
    def ack(self, tag: str) -> None: ...
    def ack_many(self, tags: Iterable[str]) -> None: ...
    def nack(self, tag: str) -> None: ...
    def qsize(self, queues: Optional[Sequence[str]] = None) -> int: ...
    def queue_names(self) -> List[str]: ...
    def inflight(self) -> int: ...
    def idle(self) -> bool: ...
    def set_visibility_timeout(self, queue: str, timeout: float) -> None: ...
    def set_max_queue_depth(self, queue: str,
                            depth: Optional[int]) -> None: ...
    def inflight_tasks(self) -> List[Tuple[Task, float]]: ...
    def heartbeat(self, consumer_id: str,
                  queues: Optional[Sequence[str]] = None) -> None: ...


class _WeightedRR:
    """Weighted round-robin queue picker shared by both local backends.

    Each cycle grants every currently-backlogged queue ``weight`` delivery
    credits (default 1); queues are then served in rotation until the cycle's
    credits run out, at which point a fresh cycle starts.  A queue flooding
    10x faster than its neighbors therefore gets at most ``weight`` slots per
    cycle instead of monopolizing delivery.  Caller must hold the backend's
    lock — this object keeps no lock of its own.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None):
        self.weights = {q: max(1, int(w)) for q, w in (weights or {}).items()}
        self.credits: Dict[str, int] = {}
        self.last: Optional[str] = None

    def pick(self, nonempty: Sequence[str]) -> str:
        order = sorted(nonempty)
        if all(self.credits.get(q, 0) <= 0 for q in order):
            # new cycle: only backlogged queues get credits, so an idle
            # queue cannot bank slots it will never use
            self.credits = {q: self.weights.get(q, 1) for q in order}
        start = (order.index(self.last) + 1) % len(order) \
            if self.last in order else 0
        for i in range(len(order)):
            q = order[(start + i) % len(order)]
            if self.credits.get(q, 0) > 0:
                self.credits[q] -= 1
                self.last = q
                return q
        # unreachable (the reset above guarantees a credit), but never pick
        # nothing if it somehow is
        self.last = order[start]
        return order[start]


def _check_fairness(fairness: str) -> str:
    if fairness not in ("priority", "weighted"):
        raise ValueError(f"fairness must be 'priority' or 'weighted', "
                         f"got {fairness!r}")
    return fairness


class InMemoryBroker:
    """Thread-safe multi-queue priority broker with visibility timeouts."""

    def __init__(self, visibility_timeout: float = 60.0,
                 queue_timeouts: Optional[Dict[str, float]] = None,
                 fairness: str = "priority",
                 queue_weights: Optional[Dict[str, float]] = None,
                 max_queue_depth: Optional[int] = None,
                 put_timeout: float = 5.0,
                 heartbeat_ttl: float = 15.0,
                 queue_depths: Optional[Dict[str, int]] = None):
        self._lock = threading.Condition()
        self._heaps: Dict[str, List[Tuple[int, int, Task]]] = {}
        self._seq = itertools.count()
        # tag -> (task, leased-at).  Expiry is computed at sweep time from
        # the queue's CURRENT visibility timeout (not frozen at lease time)
        # so set_visibility_timeout acts retroactively on in-flight leases,
        # exactly like FileBroker's sweep — the backends must not diverge
        # behind a NetBroker.
        self._leased: Dict[str, Tuple[Task, float]] = {}
        self._vt = visibility_timeout
        self._vt_queue: Dict[str, float] = dict(queue_timeouts or {})
        self._fairness = _check_fairness(fairness)
        self._rr = _WeightedRR(queue_weights)
        # backpressure: producers block while a queue holds max_queue_depth
        # pending tasks, and raise BrokerFull after put_timeout seconds
        # without forward progress.  None = unbounded (the default).
        self._max_depth = None if max_queue_depth is None \
            else max(1, int(max_queue_depth))
        # per-queue depth overrides take precedence over the global bound
        # (a queue can be bounded on an otherwise-unbounded broker)
        self._depth_queue: Dict[str, int] = {
            q: max(1, int(d)) for q, d in (queue_depths or {}).items()}
        self._put_timeout = put_timeout
        # consumer heartbeats: id -> (subscribed queues or None, last-seen)
        self._hb_ttl = heartbeat_ttl
        self._consumers: Dict[str, Tuple[Optional[Tuple[str, ...]], float]] = {}
        self._stats = {"enqueued": 0, "acked": 0, "redelivered": 0,
                       "starvation_avoided": 0}
        # per-queue ack counters feed merlin-status --watch throughput
        self._acked_q: Dict[str, int] = {}
        # live-migration marks: queue -> forward target URL.  While set,
        # consumers see the queue as empty, new puts forward to the
        # target, and in-flight leases drain in place (their acks/nacks
        # still land here).  See ShardedBroker.migrate_queue_between.
        self._migrating: Dict[str, str] = {}
        self._fwd_clients: Dict[str, Any] = {}

    @property
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s = dict(self._stats)
            s["acked_by_queue"] = dict(self._acked_q)
            s["consumers"] = self._consumers_view_locked()
            if self._migrating:
                s["migrating"] = sorted(self._migrating)
        return s

    # -- consumer heartbeats -------------------------------------------------
    def heartbeat(self, consumer_id: str,
                  queues: Optional[Sequence[str]] = None) -> None:
        """Register/refresh a consumer; entries expire after heartbeat_ttl."""
        qsel = _normalize_queues(queues)
        now = time.monotonic()
        with self._lock:
            self._consumers[consumer_id] = (qsel, now)
            dead = [c for c, (_, at) in self._consumers.items()
                    if now - at > 4 * self._hb_ttl]
            for c in dead:
                del self._consumers[c]

    def _consumers_view_locked(self) -> Dict[str, int]:
        now = time.monotonic()
        view: Dict[str, int] = {}
        for qsel, at in self._consumers.values():
            if now - at > self._hb_ttl:
                continue
            for q in (qsel if qsel is not None else ("*",)):
                view[q] = view.get(q, 0) + 1
        return view

    def set_visibility_timeout(self, queue: str, timeout: float) -> None:
        """Override the lease clock for one named queue (including leases
        already in flight, as in FileBroker)."""
        with self._lock:
            self._vt_queue[queue] = float(timeout)
            self._lock.notify_all()  # waiters recompute their next expiry

    def _vt_for(self, queue: str) -> float:
        return self._vt_queue.get(queue, self._vt)

    def _deadline(self, task: Task, leased_at: float) -> float:
        return leased_at + self._vt_for(task.queue)

    # -- per-queue depth overrides -------------------------------------------
    def set_max_queue_depth(self, queue: str, depth: Optional[int]) -> None:
        """Override (or, with ``None``, clear) one queue's depth bound."""
        with self._lock:
            if depth is None:
                self._depth_queue.pop(queue, None)
            else:
                self._depth_queue[queue] = max(1, int(depth))
            self._lock.notify_all()  # a raised bound unblocks producers

    def _depth_for(self, queue: str) -> Optional[int]:
        return self._depth_queue.get(queue, self._max_depth)

    def _bounded(self) -> bool:
        return self._max_depth is not None or bool(self._depth_queue)

    # -- producer side -----------------------------------------------------
    def _push_locked(self, task: Task) -> None:
        heap = self._heaps.setdefault(task.queue, [])
        heapq.heappush(heap, (task.priority, next(self._seq), task))

    def _wait_capacity_locked(self, queue: str, deadline: float) -> None:
        """Block while ``queue`` is at its depth bound; BrokerFull at the
        deadline.  Consumers claiming tasks notify the condition, so a
        blocked producer wakes as soon as the queue drains."""
        while True:
            limit = self._depth_for(queue)
            if limit is None or len(self._heaps.get(queue, ())) < limit:
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise BrokerFull(
                    f"queue {queue!r} held {limit} pending tasks "
                    f"for {self._put_timeout}s (max_queue_depth)")
            self._lock.wait(remaining)

    # -- live queue migration -----------------------------------------------
    def migrate_queue(self, queue: str, target: Optional[str]) -> None:
        """Mark ``queue`` migrating to ``target`` (a broker URL), or clear
        the mark with ``None``.  While marked: gets skip the queue, puts
        forward to the target, in-flight leases drain in place."""
        validate_queue_name(queue)
        orphans = []
        with self._lock:
            if target is None:
                self._migrating.pop(queue, None)
                live = set(self._migrating.values())
                orphans = [self._fwd_clients.pop(u)
                           for u in list(self._fwd_clients)
                           if u not in live]
            else:
                self._migrating[queue] = str(target)
            self._lock.notify_all()
        for c in orphans:
            close = getattr(c, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    def _forward(self, target: str, tasks: List[Task]) -> None:
        client = self._fwd_clients.get(target)
        if client is None:
            from repro_torch.core.netbroker import make_broker
            with self._lock:
                client = self._fwd_clients.get(target)
                if client is None:
                    client = self._fwd_clients[target] = make_broker(target)
        client.put_many(tasks)  # target applies its own backpressure
        with self._lock:
            self._stats["forwarded"] = \
                self._stats.get("forwarded", 0) + len(tasks)

    def export_queue(self, queue: str, max_n: int = 256) -> List[Dict[str, Any]]:
        """Atomically pop up to ``max_n`` pending tasks as wire dicts (the
        migration drain path; works on migrating and normal queues)."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            heap = self._heaps.get(queue)
            while heap and len(out) < int(max_n):
                out.append(task_to_wire(heapq.heappop(heap)[2]))
            if out:
                self._stats["exported"] = \
                    self._stats.get("exported", 0) + len(out)
                self._lock.notify_all()  # freed capacity wakes producers
        return out

    def import_tasks(self, tasks: List[Any]) -> None:
        """Enqueue exported task dicts (or Tasks).  Exempt from the depth
        bound like redelivery — the tasks were already admitted once by
        the federation; blocking a migration on a full queue would strand
        them between owners."""
        with self._lock:
            now = time.monotonic()
            for d in tasks:
                t = d if isinstance(d, Task) else Task(**d)
                t.enqueued_at = now
                self._push_locked(t)
            self._stats["imported"] = \
                self._stats.get("imported", 0) + len(tasks)
            self._lock.notify_all()

    def put(self, task: Task) -> None:
        with self._lock:
            target = self._migrating.get(task.queue)
            if target is None:
                if self._bounded():
                    self._wait_capacity_locked(
                        task.queue, time.monotonic() + self._put_timeout)
                task.enqueued_at = time.monotonic()
                self._push_locked(task)
                self._stats["enqueued"] += 1
                self._lock.notify_all()
                return
        self._forward(target, [task])

    def put_many(self, tasks: List[Task]) -> None:
        fwd: Dict[str, List[Task]] = {}
        if self._migrating:
            with self._lock:
                if self._migrating:
                    local: List[Task] = []
                    for t in tasks:
                        tgt = self._migrating.get(t.queue)
                        if tgt is None:
                            local.append(t)
                        else:
                            fwd.setdefault(tgt, []).append(t)
                    tasks = local
        try:
            if not tasks:
                return
            if not self._bounded():  # unbounded: one lock, one wakeup
                now = time.monotonic()
                with self._lock:
                    for t in tasks:
                        t.enqueued_at = now
                        self._push_locked(t)
                    self._stats["enqueued"] += len(tasks)
                    self._lock.notify_all()
                return
            self._put_many_bounded(tasks)
        finally:
            for target, ts in fwd.items():
                self._forward(target, ts)

    def _put_many_bounded(self, tasks: List[Task]) -> None:
        with self._lock:
            # ONE deadline for the whole call: put_timeout bounds total
            # blocking, so a relayed put_many can never park a server
            # handler thread past the clients' request_grace (a huge batch
            # trickling into a small bounded queue fails fast instead —
            # callers retry in chunks, e.g. the worker's gen throttle)
            deadline = time.monotonic() + self._put_timeout
            for t in tasks:
                self._wait_capacity_locked(t.queue, deadline)
                t.enqueued_at = time.monotonic()
                self._push_locked(t)
                self._stats["enqueued"] += 1
                # wake consumers per task (not once at the end): with the
                # producer parked waiting for capacity mid-batch, consumers
                # must be draining concurrently or nobody ever wakes anybody
                self._lock.notify_all()

    # -- consumer side ------------------------------------------------------
    def _pop_best_locked(self, queues: Optional[Tuple[str, ...]]) -> Optional[Task]:
        # wildcard subscribers never see dead-letter queues; dlq.* must be
        # addressed explicitly (merlin-dlq) or its tasks would re-execute.
        # Migrating queues are invisible even to explicit subscribers —
        # their pending tasks are mid-handoff to the new owner.
        names = ([q for q in self._heaps if not is_dlq(q)]
                 if queues is None else queues)
        if self._migrating:
            names = [q for q in names if q not in self._migrating]
        best_q = None
        best_key: Optional[Tuple[int, int]] = None
        nonempty: List[str] = []
        for q in names:
            heap = self._heaps.get(q)
            if not heap:
                continue
            nonempty.append(q)
            key = heap[0][:2]
            if best_key is None or key < best_key:
                best_key, best_q = key, q
        if best_q is None:
            return None
        if self._fairness == "weighted" and len(nonempty) > 1:
            pick = self._rr.pick(nonempty)
            if pick != best_q:
                self._stats["starvation_avoided"] += 1
            best_q = pick
        return heapq.heappop(self._heaps[best_q])[2]

    def _lease_locked(self, task: Task) -> Lease:
        tag = uuid.uuid4().hex
        self._leased[tag] = (task, time.monotonic())
        return Lease(task, tag)

    def _wait_locked(self, deadline: Optional[float]) -> bool:
        """Block until notified, the next lease expiry, or the deadline.

        Returns False when the deadline has passed.  No fixed polling
        slices: producers notify the condition, so idle consumers wake
        immediately on put/nack and otherwise only for expiry sweeps.
        """
        now = time.monotonic()
        if deadline is not None and now >= deadline:
            return False
        wake_at = deadline
        if self._leased:
            next_expiry = min(self._deadline(t, at)
                              for t, at in self._leased.values())
            wake_at = next_expiry if wake_at is None else min(wake_at, next_expiry)
        self._lock.wait(None if wake_at is None else max(0.0, wake_at - now))
        return True

    def get(self, timeout: Optional[float] = 0.0,
            queues: Optional[Sequence[str]] = None) -> Optional[Lease]:
        """Claim one task from the subscribed queues (None = all)."""
        leases = self.get_many(1, timeout=timeout, queues=queues)
        return leases[0] if leases else None

    def get_many(self, n: int, timeout: Optional[float] = 0.0,
                 queues: Optional[Sequence[str]] = None) -> List[Lease]:
        """Claim up to ``n`` tasks in one lock round-trip.

        Blocks (up to ``timeout``) only for the *first* task; once anything
        is available the batch is whatever can be claimed right now.
        """
        qsel = _normalize_queues(queues)
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Lease] = []
        with self._lock:
            while True:
                self._requeue_expired_locked()
                while len(out) < n:
                    task = self._pop_best_locked(qsel)
                    if task is None:
                        break
                    out.append(self._lease_locked(task))
                if out:
                    if self._bounded():
                        # claims free queue capacity: wake blocked producers
                        self._lock.notify_all()
                    return out
                if not self._wait_locked(deadline):
                    return out

    def ack(self, tag: str) -> None:
        with self._lock:
            if tag in self._leased:
                task, _ = self._leased.pop(tag)
                self._stats["acked"] += 1
                self._acked_q[task.queue] = self._acked_q.get(task.queue, 0) + 1

    def ack_many(self, tags: Iterable[str]) -> None:
        with self._lock:
            for tag in tags:
                if tag in self._leased:
                    task, _ = self._leased.pop(tag)
                    self._stats["acked"] += 1
                    self._acked_q[task.queue] = \
                        self._acked_q.get(task.queue, 0) + 1

    def nack(self, tag: str) -> None:
        """Return a leased task to its queue immediately (worker failure).

        Redelivery is exempt from the max_queue_depth bound: blocking a
        nack/expiry sweep on a full queue would wedge recovery."""
        with self._lock:
            if tag in self._leased:
                task, _ = self._leased.pop(tag)
                task.retries += 1
                self._push_locked(task)
                self._stats["redelivered"] += 1
                self._lock.notify_all()

    def _requeue_expired_locked(self) -> None:
        now = time.monotonic()
        expired = [tag for tag, (t, at) in self._leased.items()
                   if self._deadline(t, at) < now]
        for tag in expired:
            task, _ = self._leased.pop(tag)
            task.retries += 1
            self._push_locked(task)
            self._stats["redelivered"] += 1
        if expired:
            self._lock.notify_all()

    def qsize(self, queues: Optional[Sequence[str]] = None) -> int:
        qsel = _normalize_queues(queues)
        with self._lock:
            names = ([q for q in self._heaps if not is_dlq(q)]
                     if qsel is None else qsel)
            return sum(len(self._heaps.get(q, ())) for q in names)

    def queue_names(self) -> List[str]:
        with self._lock:
            return sorted(q for q, h in self._heaps.items() if h)

    def inflight(self) -> int:
        with self._lock:
            return len(self._leased)

    def inflight_tasks(self) -> List[Tuple[Task, float]]:
        """Snapshot of leased tasks with lease ages (straggler detection)."""
        now = time.monotonic()
        with self._lock:
            return [(task, now - leased_at)
                    for task, leased_at in self._leased.values()]

    def idle(self) -> bool:
        with self._lock:
            self._requeue_expired_locked()
            # dead-lettered tasks don't keep a drain alive
            return (not any(h for q, h in self._heaps.items()
                            if not is_dlq(q))
                    and not self._leased)


class FileBroker:
    """Directory-backed broker; multiprocess-safe via atomic renames.

    Layout::

        <root>/queues/<queue>/<prio:03d>-<seq:012d>-<id>.json   pending
        <root>/queues/<queue>/.tmp-<uuid>                       in-flight write
        <root>/claimed/<ts>__<queue>__<name>                    leased

    A claim renames the pending file into ``claimed/`` (os.rename is atomic
    within a filesystem); acks delete it; expiry rewrites it back into its
    queue directory with ``retries`` incremented.  This is the stand-in for
    a standalone RabbitMQ host: workers in different processes (different
    "batch jobs") coordinate only through this directory tree.

    The claim hot path is served from a cached per-queue index (a heap of
    pending filenames, which encode ``(priority, seq)`` in fixed-width
    fields so lexicographic order == delivery order).  The index is
    maintained incrementally by this instance's puts/claims and re-listed
    from disk only when it runs dry or ``rescan_interval`` elapses — O(1)
    claims instead of the seed's O(n log n) listdir+sort per poll.  Tasks
    enqueued by *other* processes are therefore picked up within one rescan
    interval; strict priority order is guaranteed among tasks the index has
    seen (global order across processes is best-effort, as with any
    distributed queue).
    """

    _TMP_PREFIX = ".tmp-"

    def __init__(self, root: str, visibility_timeout: float = 120.0,
                 rescan_interval: float = 0.25,
                 queue_timeouts: Optional[Dict[str, float]] = None,
                 fairness: str = "priority",
                 queue_weights: Optional[Dict[str, float]] = None,
                 max_queue_depth: Optional[int] = None,
                 put_timeout: float = 5.0,
                 heartbeat_ttl: float = 15.0,
                 queue_depths: Optional[Dict[str, int]] = None,
                 task_format: str = "auto"):
        if task_format not in _TASK_FORMATS:
            raise ValueError(f"task_format must be one of {_TASK_FORMATS}, "
                             f"got {task_format!r}")
        # how THIS instance writes task files; reading always sniffs the
        # format byte, so instances with different settings interoperate
        self._task_format = task_format
        self.root = root
        self.qroot = os.path.join(root, "queues")
        self.cdir = os.path.join(root, "claimed")
        # consumer heartbeats are queue state like the queue itself: one
        # file per consumer id, mtime = last seen, visible to every
        # instance sharing this directory
        self.hbdir = os.path.join(root, "consumers")
        os.makedirs(self.qroot, exist_ok=True)
        os.makedirs(self.cdir, exist_ok=True)
        self._max_depth = None if max_queue_depth is None \
            else max(1, int(max_queue_depth))
        self._put_timeout = put_timeout
        # serializes THIS instance's bounded puts so its own threads can't
        # race the check-then-write and overshoot the depth bound; across
        # processes the bound stays best-effort (see _wait_capacity)
        self._plock = threading.Lock()
        # per-queue depth overrides are shared queue state like .vt.json:
        # persisted to <root>/.depth.json so other instances' producers
        # honor them (reloaded on sweeps and, throttled, on puts)
        self._depthconf = jsonstore.SharedJsonConfig(
            os.path.join(root, ".depth.json"))
        self._depth_queue: Dict[str, int] = {}
        self._last_depth_check = 0.0
        self._load_depthconf()
        if queue_depths:
            ov = {q: max(1, int(d)) for q, d in queue_depths.items()}
            doc = self._depthconf.update(lambda d: d.update(ov))
            self._depth_queue = {q: max(1, int(d)) for q, d in doc.items()}
        self._hb_ttl = heartbeat_ttl
        self._vt = visibility_timeout
        self._seq = itertools.count(int(time.time() * 1e3) % 10 ** 9)
        self._rescan_interval = rescan_interval
        # per-queue visibility overrides are shared state like the queue
        # itself: persisted to <root>/.vt.json so every instance on this
        # directory (other processes' sweeps included) honors them
        self._vtconf = jsonstore.SharedJsonConfig(
            os.path.join(root, ".vt.json"))
        self._vt_queue: Dict[str, float] = {}
        self._load_vtconf()
        self._vt_queue.update(queue_timeouts or {})
        self._fairness = _check_fairness(fairness)
        self._rr = _WeightedRR(queue_weights)
        self._recompute_sweep_interval()
        # the cached index is in-process state shared by consumer threads
        # (WorkerPool); filesystem ops are atomic on their own, but the
        # peek-then-pop on the heaps needs a lock
        self._ilock = threading.Lock()
        self._index: Dict[str, List[str]] = {}   # queue -> heap of pending names
        self._last_rescan: Dict[str, float] = {}  # per queue, not global: a
        # rescan for one subscription must not suppress another's
        self._last_discover = 0.0
        self._last_sweep = 0.0
        self._last_tmp_reap = 0.0
        # stale-claim tracking: when another instance (process/thread on the
        # same root) wins the rename race, our index entry was stale; the
        # consumer loop uses this signal to force an immediate re-list
        # instead of sleeping through the rescan throttle
        self._saw_stale = False
        self._stats = {"enqueued": 0, "acked": 0, "redelivered": 0,
                       "stale_claims": 0, "starvation_avoided": 0}
        # per-queue ack counters (this instance's acks only — each worker
        # process counts its own work) feed merlin-status --watch rates
        self._acked_q: Dict[str, int] = {}
        # live-migration marks (in-memory, held by the serving instance):
        # queue -> forward target URL.  See InMemoryBroker._migrating.
        self._migrating: Dict[str, str] = {}
        self._fwd_clients: Dict[str, Any] = {}
        if queue_timeouts:  # constructor overrides are shared state too
            self._save_vtconf()

    @property
    def stats(self) -> Dict[str, Any]:
        with self._ilock:
            s = dict(self._stats)
            s["acked_by_queue"] = dict(self._acked_q)
            if self._migrating:
                s["migrating"] = sorted(self._migrating)
        s["consumers"] = self._consumers_view()
        return s

    # -- consumer heartbeats -------------------------------------------------
    def heartbeat(self, consumer_id: str,
                  queues: Optional[Sequence[str]] = None) -> None:
        """Write/refresh this consumer's heartbeat file (atomic rename)."""
        qsel = _normalize_queues(queues)
        os.makedirs(self.hbdir, exist_ok=True)
        safe = "hb-" + "".join(c if c.isalnum() or c in "-_.:" else "_"
                               for c in consumer_id)
        tmp = os.path.join(self.hbdir, f"{self._TMP_PREFIX}{uuid.uuid4().hex}")
        try:
            with open(tmp, "w") as f:
                json.dump({"id": consumer_id,
                           "queues": None if qsel is None else list(qsel)}, f)
            os.rename(tmp, os.path.join(self.hbdir, safe + ".json"))
        except OSError:
            pass  # heartbeat is advisory: never fail the worker over it

    def _consumers_view(self) -> Dict[str, int]:
        now = time.time()
        view: Dict[str, int] = {}
        try:
            names = os.listdir(self.hbdir)
        except OSError:
            return view
        for n in names:
            if n.startswith("."):
                continue
            path = os.path.join(self.hbdir, n)
            try:
                age = now - os.path.getmtime(path)
                if age > self._hb_ttl:
                    if age > 4 * self._hb_ttl:
                        os.unlink(path)  # reap long-dead consumers
                    continue
                with open(path) as f:
                    conf = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            for q in (conf.get("queues") or ("*",)):
                view[q] = view.get(q, 0) + 1
        return view

    # -- per-queue visibility timeouts ---------------------------------------
    def set_visibility_timeout(self, queue: str, timeout: float) -> None:
        """Override the lease clock for one named queue.

        Takes effect at the next expiry sweep (claims store their claim
        timestamp, not a deadline), including sweeps run by *other*
        instances on this directory: the override is persisted to
        ``<root>/.vt.json`` and reloaded when its signature changes.
        """
        with self._ilock:
            self._load_vtconf()
            self._vt_queue[queue] = float(timeout)
            self._recompute_sweep_interval()
        # locked merge via jsonstore: concurrent writers from any process
        # serialize on the .vt.json.lock sidecar instead of dropping each
        # other's overrides (the old unlocked merge-before-write race)
        self._save_vtconf()

    def _vt_for(self, queue: str) -> float:
        return self._vt_queue.get(queue, self._vt)

    def _recompute_sweep_interval(self) -> None:
        min_vt = min([self._vt] + list(self._vt_queue.values()))
        self._sweep_interval = min(1.0, max(0.05, min_vt / 4.0))

    def _save_vtconf(self) -> None:
        """Merge this instance's overrides into the shared file (locked)."""
        ov = {q: float(t) for q, t in self._vt_queue.items()}
        self._vtconf.update(lambda doc: doc.update(ov))

    def _load_vtconf(self) -> None:
        doc = self._vtconf.load_if_changed()
        if doc is None:
            return
        self._vt_queue.update({q: float(t) for q, t in doc.items()})
        # a shorter timeout learned from another instance must also tighten
        # OUR sweep cadence, or its leases expire up to a full (stale)
        # sweep interval late
        self._recompute_sweep_interval()

    # -- per-queue depth overrides -------------------------------------------
    def set_max_queue_depth(self, queue: str, depth: Optional[int]) -> None:
        """Override (or clear, with ``None``) one queue's depth bound.

        Persisted to ``<root>/.depth.json`` so other instances on this
        directory pick it up: their sweeps reload eagerly, their put paths
        re-check the file signature at most twice a second (an override is
        rare, slowly-changing config — ops, not dataplane).  The
        read-merge-write is serialized ACROSS processes by jsonstore's
        fcntl lock sidecar — unlocked merging would let two processes'
        concurrent overrides silently drop one (and, because loads REPLACE
        the local view, later erase the loser's own bound).
        """
        def _apply(doc: Dict[str, Any]) -> None:
            if depth is None:
                doc.pop(queue, None)
            else:
                doc[queue] = max(1, int(depth))
        with self._ilock:
            doc = self._depthconf.update(_apply)
            # the file is authoritative (REPLACE, not update): clearing an
            # override must propagate, not resurrect
            self._depth_queue = {q: max(1, int(d)) for q, d in doc.items()}

    def _depth_for(self, queue: str) -> Optional[int]:
        return self._depth_queue.get(queue, self._max_depth)

    def _load_depthconf(self, force: bool = False) -> None:
        """Reload overrides when the file changed (throttled to 0.5s unless
        forced — puts call this on their hot path)."""
        now = time.monotonic()
        if not force and now - self._last_depth_check < 0.5:
            return
        self._last_depth_check = now
        doc = self._depthconf.load_if_changed()
        if doc is None:
            return
        # REPLACE semantics (see set_max_queue_depth)
        self._depth_queue = {q: max(1, int(d)) for q, d in doc.items()}

    # -- paths ---------------------------------------------------------------
    def _qdir(self, queue: str) -> str:
        return os.path.join(self.qroot, queue)

    def _ensure_queue(self, queue: str) -> str:
        validate_queue_name(queue)  # backstop; Task construction validated
        qdir = self._qdir(queue)
        with self._ilock:
            if queue not in self._index:
                os.makedirs(qdir, exist_ok=True)
                self._index[queue] = []
        return qdir

    # -- producer side -------------------------------------------------------
    @staticmethod
    def _check_priority(task: Task) -> None:
        if not 0 <= task.priority <= 999:
            # the filename encodes priority as %03d so lexicographic order
            # == delivery order; out-of-range values would silently
            # mis-sort on disk while ordering fine in-memory
            raise ValueError(f"FileBroker priority must be in [0, 999], "
                             f"got {task.priority}")

    def _pending_count(self, queue: str) -> int:
        try:
            return sum(1 for n in os.listdir(self._qdir(queue))
                       if not n.startswith("."))
        except OSError:
            return 0

    def _wait_capacity(self, queue: str, deadline: float) -> int:
        """Return available room (>= 1) in ``queue``; BrokerFull when it
        stays at its depth bound until the deadline.  Counts the directory
        (not the cached index) so other processes' puts count against the
        bound — but the check-then-write is unlocked across processes, so
        concurrent producers in different processes can briefly overshoot
        by their batch sizes (best-effort, like every cross-process
        property of this directory-based broker).  Within one instance,
        ``_plock`` serializes producers and the bound is exact."""
        while True:
            limit = self._depth_for(queue)
            if limit is None:
                return 1 << 30  # override cleared while we waited
            room = limit - self._pending_count(queue)
            if room > 0:
                return room
            if time.monotonic() >= deadline:
                raise BrokerFull(
                    f"queue {queue!r} held {limit} pending tasks "
                    f"for {self._put_timeout}s (max_queue_depth)")
            time.sleep(0.02)

    def _write_pending(self, qdir: str, task: Task) -> str:
        """Write one task file (temp + atomic rename); returns its name."""
        name = f"{task.priority:03d}-{next(self._seq):012d}-{task.id}.json"
        # temp lives INSIDE the queue dir (same fs, skipped by the index and
        # reaped by the expiry sweep if a crashed producer leaks it)
        tmp = os.path.join(qdir, f"{self._TMP_PREFIX}{uuid.uuid4().hex}")
        with open(tmp, "wb") as f:
            f.write(encode_task_file(task, self._task_format))
        os.rename(tmp, os.path.join(qdir, name))
        return name

    # -- live queue migration -----------------------------------------------
    def migrate_queue(self, queue: str, target: Optional[str]) -> None:
        """Mark ``queue`` migrating to ``target`` (a broker URL), or clear
        the mark with ``None``.  The mark is in-memory state of the
        serving instance (one BrokerServer per root): while set, gets skip
        the queue, puts forward, in-flight leases drain in place."""
        validate_queue_name(queue)
        orphans = []
        with self._ilock:
            if target is None:
                self._migrating.pop(queue, None)
                live = set(self._migrating.values())
                orphans = [self._fwd_clients.pop(u)
                           for u in list(self._fwd_clients)
                           if u not in live]
            else:
                self._migrating[queue] = str(target)
        for c in orphans:
            close = getattr(c, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    def _forward(self, target: str, tasks: List[Task]) -> None:
        client = self._fwd_clients.get(target)
        if client is None:
            from repro_torch.core.netbroker import make_broker
            with self._ilock:
                client = self._fwd_clients.get(target)
                if client is None:
                    client = self._fwd_clients[target] = make_broker(target)
        client.put_many(tasks)  # target applies its own backpressure
        with self._ilock:
            self._stats["forwarded"] = \
                self._stats.get("forwarded", 0) + len(tasks)

    def export_queue(self, queue: str, max_n: int = 256) -> List[Dict[str, Any]]:
        """Atomically pop up to ``max_n`` pending tasks as wire dicts.

        Each task file is claimed by atomic rename (so concurrent local
        consumers cannot double-deliver it), decoded, and removed.  The
        migration orchestrator imports the returned batch on the new
        owner; a crash between export and import is the at-least-once
        window every pull-based handoff has — the exactly-once *completion*
        guarantee stays with the once-marker machinery downstream."""
        validate_queue_name(queue)
        out: List[Dict[str, Any]] = []
        self._rescan((queue,), force=True)
        while len(out) < int(max_n):
            with self._ilock:
                heap = self._index.get(queue)
                name = heapq.heappop(heap) if heap else None
            if name is None:
                break
            src = os.path.join(self._qdir(queue), name)
            dst = os.path.join(self.cdir,
                               f"{time.time():.6f}__{queue}__{name}")
            try:
                os.rename(src, dst)  # atomic claim-for-export
            except OSError:
                with self._ilock:
                    self._saw_stale = True
                continue
            try:
                with open(dst, "rb") as f:
                    task = decode_task_file(f.read())
            except (OSError, json.JSONDecodeError, TypeError, ValueError):
                self._dead_letter(dst)
                continue
            out.append(task_to_wire(task))
            try:
                os.unlink(dst)
            except OSError:
                pass
        if out:
            with self._ilock:
                self._stats["exported"] = \
                    self._stats.get("exported", 0) + len(out)
        return out

    def import_tasks(self, tasks: List[Any]) -> None:
        """Enqueue exported task dicts (or Tasks), exempt from the depth
        bound like nack redelivery — the federation already admitted them
        once; blocking mid-migration would strand them between owners."""
        now = time.time()
        by_q: Dict[str, List[Task]] = {}
        for d in tasks:
            t = d if isinstance(d, Task) else Task(**d)
            self._check_priority(t)
            t.enqueued_at = now
            by_q.setdefault(t.queue, []).append(t)
        for queue, ts in by_q.items():
            qdir = self._ensure_queue(queue)
            names = [self._write_pending(qdir, t) for t in ts]
            with self._ilock:
                index = self._index[queue]
                for name in names:
                    heapq.heappush(index, name)
                self._stats["imported"] = \
                    self._stats.get("imported", 0) + len(names)

    def put(self, task: Task) -> None:
        self._check_priority(task)
        if self._migrating:
            with self._ilock:
                target = self._migrating.get(task.queue)
            if target is not None:
                self._forward(target, [task])
                return
        qdir = self._ensure_queue(task.queue)
        self._load_depthconf()  # throttled: other instances' overrides
        if self._depth_for(task.queue) is not None:
            # deadline BEFORE the producer lock: time queued behind another
            # blocked producer counts against put_timeout, so total
            # blocking stays bounded per call (the documented contract)
            deadline = time.monotonic() + self._put_timeout
            with self._plock:
                self._wait_capacity(task.queue, deadline)
                task.enqueued_at = time.time()
                name = self._write_pending(qdir, task)
        else:
            task.enqueued_at = time.time()
            name = self._write_pending(qdir, task)
        with self._ilock:
            heapq.heappush(self._index[task.queue], name)
            self._stats["enqueued"] += 1

    def put_many(self, tasks: List[Task]) -> None:
        """Batched enqueue: per *queue*, one `_ensure_queue` check, all
        task files written (temp + atomic rename each), then ONE locked
        index merge + stats bump — not a per-task put() loop.  Behind a
        BrokerServer a 1000-task batch previously took 1000 lock
        acquisitions and heappushes while consumers fought for the same
        lock; now it takes one per queue (per capacity chunk)."""
        now = time.time()
        by_q: Dict[str, List[Task]] = {}
        for t in tasks:
            self._check_priority(t)
            t.enqueued_at = now
            by_q.setdefault(t.queue, []).append(t)
        if self._migrating:
            with self._ilock:
                marks = {q: self._migrating[q] for q in by_q
                         if q in self._migrating}
            for q, target in marks.items():
                self._forward(target, by_q.pop(q))
        self._load_depthconf()  # throttled: other instances' overrides
        for queue, ts in by_q.items():
            qdir = self._ensure_queue(queue)
            if self._depth_for(queue) is not None:
                # ONE deadline for the whole queue batch, computed BEFORE
                # the producer lock (put_timeout bounds total blocking
                # including time queued behind other producers — a
                # server-relayed put_many must never outlast the clients'
                # request_grace); producers of this instance serialized so
                # they can't jointly overshoot the bound
                deadline = time.monotonic() + self._put_timeout
                with self._plock:
                    i = 0
                    while i < len(ts):
                        # admit in capacity-sized chunks; _wait_capacity
                        # blocks until room exists, BrokerFull at deadline
                        room = min(len(ts) - i,
                                   self._wait_capacity(queue, deadline))
                        self._index_chunk(qdir, queue, ts[i:i + room])
                        i += room
            else:
                self._index_chunk(qdir, queue, ts)

    def _index_chunk(self, qdir: str, queue: str, chunk: List[Task]) -> None:
        """Write a run of task files, then ONE locked index merge."""
        names = [self._write_pending(qdir, t) for t in chunk]
        with self._ilock:
            index = self._index[queue]
            for name in names:
                heapq.heappush(index, name)
            self._stats["enqueued"] += len(names)

    # -- index maintenance ---------------------------------------------------
    def _rescan(self, queues: Optional[Tuple[str, ...]],
                force: bool = False) -> None:
        """Re-list pending files from disk (picks up other processes' puts).

        Self-throttled per queue on ``rescan_interval`` — a never-scanned
        queue is always stale, so a fresh instance or subscription sees
        disk immediately.  ``force=True`` bypasses the throttle: used after
        stale-index claim races (another worker renamed a file we still had
        indexed), where waiting out the throttle would starve this consumer
        of work that IS on disk.
        """
        now = time.monotonic()
        if queues is None:
            if force or self._last_discover == 0.0 or \
                    now - self._last_discover > self._rescan_interval:
                self._last_discover = now
                try:
                    queues = tuple(q for q in os.listdir(self.qroot)
                                   if os.path.isdir(self._qdir(q)))
                except OSError:
                    queues = ()
            else:
                with self._ilock:
                    queues = tuple(self._index)
        for q in queues:
            if not force and \
                    now - self._last_rescan.get(q, 0.0) <= self._rescan_interval:
                continue
            try:
                names = [n for n in os.listdir(self._qdir(q))
                         if not n.startswith(".")]
            except OSError:
                continue
            with self._ilock:
                # union-merge, never replace: a concurrent same-process
                # put()/nack() may have pushed a name after our listdir
                # snapshot; replacing would silently drop it.  Stale
                # entries (claimed since the snapshot) just fail their
                # rename and are skipped.
                merged = list(set(names) | set(self._index.get(q, ())))
                heapq.heapify(merged)
                self._index[q] = merged
            self._last_rescan[q] = now

    def _pop_best(self, queues: Optional[Tuple[str, ...]]) -> Optional[Tuple[str, str]]:
        with self._ilock:
            # wildcard consumers skip dead-letter queues (see DLQ_PREFIX);
            # migrating queues are invisible even to explicit subscribers
            names = ([q for q in self._index if not is_dlq(q)]
                     if queues is None else queues)
            if self._migrating:
                names = [q for q in names if q not in self._migrating]
            best_q = None
            nonempty = []
            for q in names:
                heap = self._index.get(q)
                if not heap:
                    continue
                nonempty.append(q)
                if best_q is None or heap[0] < self._index[best_q][0]:
                    best_q = q
            if best_q is None:
                return None
            if self._fairness == "weighted" and len(nonempty) > 1:
                pick = self._rr.pick(nonempty)
                if pick != best_q:
                    self._stats["starvation_avoided"] += 1
                best_q = pick
            return best_q, heapq.heappop(self._index[best_q])

    def _dead_letter(self, path: str) -> None:
        """Quarantine an unparseable task file so it can't cycle forever
        between pending and claimed (it would otherwise pin idle() False)."""
        ddir = os.path.join(self.root, "dead")
        os.makedirs(ddir, exist_ok=True)
        try:
            os.rename(path, os.path.join(ddir, os.path.basename(path)))
        except OSError:
            pass

    def _try_claim(self, queues: Optional[Tuple[str, ...]]) -> Optional[Lease]:
        while True:
            picked = self._pop_best(queues)
            if picked is None:
                return None
            best_q, name = picked
            src = os.path.join(self._qdir(best_q), name)
            dst = os.path.join(self.cdir, f"{time.time():.6f}__{best_q}__{name}")
            try:
                os.rename(src, dst)  # atomic claim
            except OSError:
                # another worker won the rename race; our index entry was
                # stale.  Record it so the consumer loop can force a fresh
                # disk listing instead of concluding the queue is empty.
                with self._ilock:
                    self._saw_stale = True
                    self._stats["stale_claims"] += 1
                continue
            try:
                with open(dst, "rb") as f:
                    task = decode_task_file(f.read())
            except (OSError, json.JSONDecodeError, TypeError, ValueError):
                # unparseable (either format — CodecError is a ValueError)
                # OR carrying an invalid queue name (ValueError from Task
                # validation): quarantine, move on
                self._dead_letter(dst)
                continue
            return Lease(task, dst)

    # -- consumer side -------------------------------------------------------
    def get(self, timeout: Optional[float] = 0.0,
            queues: Optional[Sequence[str]] = None) -> Optional[Lease]:
        leases = self.get_many(1, timeout=timeout, queues=queues)
        return leases[0] if leases else None

    def get_many(self, n: int, timeout: Optional[float] = 0.0,
                 queues: Optional[Sequence[str]] = None) -> List[Lease]:
        qsel = _normalize_queues(queues)
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Lease] = []
        fresh = False  # index reflects a disk scan done this wait cycle
        while True:
            with self._ilock:
                # check-and-set under the lock: exactly one consumer thread
                # runs each sweep, so two threads can't both nack the same
                # expired claim (double-redelivery / double-counted stats)
                sweep_due = time.monotonic() - self._last_sweep > self._sweep_interval
                if sweep_due:
                    self._last_sweep = time.monotonic()
            if sweep_due:
                self._requeue_expired()
            while len(out) < n:
                lease = self._try_claim(qsel)
                if lease is None:
                    break
                out.append(lease)
            if out:
                return out
            if not fresh:
                # index ran dry: consult disk for other processes' puts.
                # _rescan self-throttles per queue, so idle consumers do
                # NOT reintroduce the listdir-per-poll load the cached
                # index exists to remove.  Exception: if this claim round
                # lost rename races (stale index entries), other consumers
                # are actively draining the same directory and pending work
                # may exist that we have never listed — force the rescan
                # so contention degrades to extra listdirs, not to lost
                # throughput while the throttle runs out.
                with self._ilock:
                    force, self._saw_stale = self._saw_stale, False
                self._rescan(qsel, force=force)
                fresh = True
                continue
            if deadline is not None and time.monotonic() >= deadline:
                return out
            time.sleep(0.02)
            fresh = False

    def ack(self, tag: str) -> None:
        try:
            os.unlink(tag)
        except OSError:
            return
        # claim tags are "<ts>__<queue>__<name>": recover the queue for the
        # per-queue ack counter without touching the (deleted) payload
        try:
            queue = os.path.basename(tag).split("__", 2)[1]
        except IndexError:
            queue = ""
        with self._ilock:
            self._stats["acked"] += 1
            if queue:
                self._acked_q[queue] = self._acked_q.get(queue, 0) + 1

    def ack_many(self, tags: Iterable[str]) -> None:
        for tag in tags:
            self.ack(tag)

    def nack(self, tag: str) -> None:
        """Requeue a leased task, incrementing its retry count."""
        base = os.path.basename(tag)
        try:
            _, queue, name = base.split("__", 2)
        except ValueError:
            return
        qdir = self._ensure_queue(queue)
        dst = os.path.join(qdir, name)
        try:
            with open(tag, "rb") as f:
                raw = f.read()
        except OSError:
            return  # claim already gone: a concurrent sweep/ack won
        try:
            task = decode_task_file(raw)
        except (json.JSONDecodeError, TypeError, ValueError):
            # unparseable poison: redelivering would ping-pong it between
            # pending and claimed forever (retries can never increment)
            self._dead_letter(tag)
            return
        task.retries += 1
        tmp = os.path.join(qdir, f"{self._TMP_PREFIX}{uuid.uuid4().hex}")
        try:
            with open(tmp, "wb") as f:
                f.write(encode_task_file(task, self._task_format))
            os.rename(tmp, dst)
        except OSError:
            return
        try:
            os.unlink(tag)
        except OSError:
            pass
        with self._ilock:
            heapq.heappush(self._index.setdefault(queue, []), name)
            self._stats["redelivered"] += 1

    def _requeue_expired(self) -> None:
        """Expiry sweep: redeliver timed-out leases, reap leaked temp files."""
        self._last_sweep = time.monotonic()
        self._load_vtconf()  # pick up other instances' per-queue overrides
        self._load_depthconf(force=True)  # ... and their depth bounds
        now = time.time()
        for name in os.listdir(self.cdir):
            try:
                ts_s, queue, _ = name.split("__", 2)
                ts = float(ts_s)
            except ValueError:
                continue
            if now - ts > self._vt_for(queue):
                self.nack(os.path.join(self.cdir, name))
        # reap temps a crashed producer left behind (live producers hold a
        # temp for microseconds; anything older than the lease window is
        # junk).  Own, longer cadence: idle()/drain() polls call this sweep
        # every ~20 ms and must not pay a full per-queue directory walk
        tmp_max_age = max(30.0, self._vt)
        if self._last_tmp_reap != 0.0 and \
                time.monotonic() - self._last_tmp_reap < tmp_max_age / 2:
            return
        self._last_tmp_reap = time.monotonic()
        try:
            queues = os.listdir(self.qroot)
        except OSError:
            queues = []
        for q in queues:
            qdir = self._qdir(q)
            try:
                names = os.listdir(qdir)
            except OSError:
                continue
            for n in names:
                if not n.startswith(self._TMP_PREFIX):
                    continue
                path = os.path.join(qdir, n)
                try:
                    if now - os.path.getmtime(path) > tmp_max_age:
                        os.unlink(path)
                except OSError:
                    pass
        # prune stale consumer heartbeat files on the same cadence: the
        # read path (_consumers_view) reaps long-dead entries only when
        # someone actually reads stats, so an unwatched root would grow
        # <root>/consumers/ forever as worker fleets churn
        try:
            hb_names = os.listdir(self.hbdir)
        except OSError:
            hb_names = []
        for n in hb_names:
            path = os.path.join(self.hbdir, n)
            try:
                if now - os.path.getmtime(path) > 4 * self._hb_ttl:
                    os.unlink(path)
            except OSError:
                pass

    # -- introspection -------------------------------------------------------
    def qsize(self, queues: Optional[Sequence[str]] = None) -> int:
        qsel = _normalize_queues(queues)
        if qsel is None:
            # wildcard size mirrors wildcard consumption: no dlq.* queues
            try:
                qsel = tuple(q for q in os.listdir(self.qroot)
                             if not is_dlq(q))
            except OSError:
                return 0
        total = 0
        for q in qsel:
            try:
                total += sum(1 for n in os.listdir(self._qdir(q))
                             if not n.startswith("."))
            except OSError:
                pass
        return total

    def queue_names(self) -> List[str]:
        try:
            return sorted(q for q in os.listdir(self.qroot)
                          if self.qsize((q,)) > 0)
        except OSError:
            return []

    def inflight(self) -> int:
        return len(os.listdir(self.cdir))

    def inflight_tasks(self) -> List[Tuple[Task, float]]:
        """Snapshot of leased tasks with lease ages (straggler detection)."""
        now = time.time()
        out: List[Tuple[Task, float]] = []
        for name in os.listdir(self.cdir):
            try:
                ts = float(name.split("__", 1)[0])
                with open(os.path.join(self.cdir, name), "rb") as f:
                    task = decode_task_file(f.read())
            except (ValueError, OSError, json.JSONDecodeError, TypeError):
                continue  # claim vanished (acked) or poison mid-read
            out.append((task, now - ts))
        return out

    def idle(self) -> bool:
        self._requeue_expired()
        return self.qsize() == 0 and self.inflight() == 0
