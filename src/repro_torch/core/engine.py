"""ExecutionEngine: the shared micro-batching scheduler between lease
pumps and device execution.

Before this module, batching policy lived inside each worker thread: one
``get_many`` lease batch was the largest unit the runtime could fuse into
a single device launch (``execute_real_many``), so the fusion width was
capped by ``batch`` *per worker* — and under a multi-worker pool the
interleaved claims shredded contiguity, so most "batches" degenerated to
per-task launches anyway.  The engine moves that policy into one shared,
testable component:

* **Workers become pure lease pumps.**  A worker leases, submits its real
  fn-step tasks here, waits for the per-task outcomes, and acks/nacks —
  it never calls the executor itself.  Leases stay worker-held, so the
  broker's at-least-once / visibility-timeout story is unchanged.
* **Deadline-based micro-batching.**  Submissions accumulate in a buffer
  that is flushed when it reaches ``max_batch`` tasks or when the oldest
  submission has waited ``max_wait_ms`` — whichever comes first (the
  classic size-or-deadline batching rule).  A flush hands the whole
  buffer to ``MerlinRuntime.execute_real_many``, which coalesces
  compatible tasks (same study/stage/combo, contiguous sample ranges)
  into fused device launches — **across get_many batches, across
  workers, and across queues**, because every worker of a runtime feeds
  the same buffer.
* **Per-task semantics preserved.**  ``execute_real_many`` keeps the
  ``ctx.sub_ranges`` contract (one bundle file + once-marker +
  ``_bundle_done`` per original task).  If a fused flush fails, the
  engine falls back to per-task ``execute_real`` so a poison task
  resolves with *its own* error while its batch-mates complete — the
  worker then acks the survivors and retries/dead-letters only the
  poison task.
* **Observability.**  ``stats()`` reports batches fused, a tasks-per-
  batch histogram, how many flushes were triggered by size vs deadline
  vs an explicit ``flush()``, and the busy fraction (the share of
  wall-clock the engine spent inside fused execution — the scheduler's
  proxy for device utilization; the sample-level view, real vs padded
  device rows, is ``EnsembleExecutor.stats``).

Lifecycle: engines are shared and reference-counted.  ``MerlinRuntime.
shared_engine()`` hands every WorkerPool of a runtime the same instance
(cross-pool coalescing); each pool ``attach()``-es on start and
``detach()``-es on shutdown, and the last detach closes the dispatcher
thread.  ``flush()`` forces the current partial buffer out immediately —
``WorkerPool.drain``/``shutdown`` call it so a partially-filled
micro-batch never strands leased tasks until their visibility timeout.

Tuning ``max_wait_ms``: it is the latency floor a lone task pays for the
chance to be fused.  Keep it well below the broker visibility timeout
and in the order of one device launch (a few ms on CPU); raise it when
many slow pumps feed one engine, lower it toward zero to approximate
per-batch execution.

With ``adaptive=True`` (the default) the engine also tracks an EMA of
submission inter-arrival gaps.  When arrivals are *slower* than
``max_wait_ms`` — i.e. waiting out the full deadline cannot buy extra
fusion because the next task will not arrive in time — the dispatcher
flushes early once the buffer has sat idle for a short grace period
(``max_wait / 4``).  Bursty pumps (gaps well under the window) are
unaffected, so fusion behaviour under load is identical; only the
lone-straggler latency improves.  Such flushes are counted in
``stats()["adaptive_flushes"]``.

Two further scheduler policies live here:

* **Affinity-keyed batching.**  Each pending task carries an affinity
  key (``runtime.affinity_key(task)``, ``(study, simulator)`` for real
  runtimes) and a dispatch only ever takes tasks sharing the key of the
  oldest buffered task — two studies' bundles never interleave inside
  one fused launch, which would otherwise shred ``execute_real_many``'s
  contiguity grouping into per-study fragments of a half-empty batch.

* **Write pipelining.**  When the runtime offers
  ``execute_real_many_deferred``, device compute is dispatched on the
  engine thread while the host-side completion (``block_until_ready`` +
  bundle writes + once-markers) runs on a single writer thread — so the
  dispatch of batch N+1 overlaps the write of batch N.  Handles still
  resolve only after the durable write (ack-after-durable is preserved);
  ``stats()["write_overlap_s"]`` reports how much write time was hidden
  behind concurrent dispatch.

:class:`ContinuousBatcher` (bottom of this module) is the engine's
serving-side sibling: instead of leased workflow tasks it batches
latency-sensitive inference *requests* — admitted continuously at
power-of-two bucket boundaries, deadline-ordered, with a bounded
admission queue that sheds load as ``BrokerFull``.  The HTTP gateway
(``repro_torch.serve.gateway``) fronts it.
"""
from __future__ import annotations

import heapq
import math
import threading
import time
from queue import Queue
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.queue import BrokerFull, Task


class EngineClosed(RuntimeError):
    """Submission after the engine's dispatcher has been shut down."""


class DeadlineExpired(RuntimeError):
    """A serve request's deadline passed before it was admitted to a
    batch; it was dropped without executing (the gateway maps it to 504)."""


class PendingTask:
    """A submitted task's completion handle (resolved by the dispatcher).

    ``error`` is None on success, or the exception the task's (fallback,
    per-task) execution raised — the worker maps it to nack/dead-letter.
    """

    __slots__ = ("task", "event", "error", "key", "submitted_at")

    def __init__(self, task: Task, key=None):
        self.task = task
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.key = key  # affinity bucket: tasks only batch with key-mates
        self.submitted_at: float = 0.0

    def done(self) -> bool:
        return self.event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.event.wait(timeout)

    def _resolve(self, error: Optional[BaseException]) -> None:
        self.error = error
        self.event.set()


class ExecutionEngine:
    """Shared size-or-deadline micro-batching scheduler over one runtime."""

    _GAP_ALPHA = 0.4  # EMA smoothing for submission inter-arrival gaps

    def __init__(self, runtime, max_batch: int = 32,
                 max_wait_ms: float = 8.0, adaptive: bool = True):
        self.runtime = runtime
        self.max_batch = max(1, int(max_batch))
        self.max_wait = max(0.0, float(max_wait_ms) / 1000.0)
        self.adaptive = bool(adaptive)
        self._idle_grace = self.max_wait * 0.25
        self._cv = threading.Condition()
        self._buf: List[PendingTask] = []
        self._deadline: Optional[float] = None
        self._flush_asked = False
        self._closed = False
        self._refs = 0
        self._thread: Optional[threading.Thread] = None
        self._t0: Optional[float] = None  # first submission (uptime clock)
        self._last_submit: Optional[float] = None
        self._ema_gap: Optional[float] = None
        # write pipeline: the dispatcher hands (batch, finalize) pairs to a
        # single writer thread so host syncs + bundle writes overlap the
        # next batch's device dispatch.  Bounded: the dispatcher stalls
        # when the writer falls more than two batches behind.
        self._wq: Optional[Queue] = None
        self._writer: Optional[threading.Thread] = None
        self._busy_since: Optional[float] = None  # dispatch-in-progress mark
        self._busy_accum = 0.0  # completed dispatch time (overlap metric)
        self._stats: Dict[str, object] = {
            "submitted": 0, "executed": 0, "failed_tasks": 0,
            "batches": 0, "size_flushes": 0, "deadline_flushes": 0,
            "forced_flushes": 0, "adaptive_flushes": 0, "max_batch_seen": 0,
            "exec_s": 0.0, "batch_hist": {}, "affinity_splits": 0,
            "deferred_batches": 0, "write_s": 0.0, "write_overlap_s": 0.0,
        }

    # -- lifecycle -----------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def refs(self) -> int:
        """How many users (WorkerPools) are currently attached."""
        with self._cv:
            return self._refs

    def buffered(self) -> int:
        """Tasks currently waiting in the micro-batch buffer (cheap,
        local — lets drain loops avoid broker round-trips when there is
        nothing to flush anyway)."""
        with self._cv:
            return len(self._buf)

    def attach(self) -> "ExecutionEngine":
        """Reference-count a user (a WorkerPool); pair with detach()."""
        with self._cv:
            if self._closed:
                raise EngineClosed("cannot attach to a closed engine")
            self._refs += 1
        return self

    def detach(self) -> None:
        """Drop one reference; the last detach closes the dispatcher."""
        with self._cv:
            self._refs -= 1
            last = self._refs <= 0
        if last:
            self.close()

    def close(self, timeout: float = 10.0) -> None:
        """Flush whatever is buffered, then stop the dispatcher thread."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        if self._writer is not None:
            self._wq.put(None)  # sentinel after the dispatcher drained
            self._writer.join(timeout=timeout)
        # belt-and-braces: the dispatcher drains the buffer before exiting,
        # but if it died (or never ran), nobody may wait forever on us
        with self._cv:
            leftovers, self._buf = self._buf, []
        for p in leftovers:
            p._resolve(EngineClosed("engine closed before execution"))

    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="merlin-exec-engine")
            self._thread.start()

    # -- submission ----------------------------------------------------------
    def submit(self, task: Task) -> PendingTask:
        return self.submit_many([task])[0]

    def submit_many(self, tasks: Sequence[Task]) -> List[PendingTask]:
        """Queue tasks for fused execution; returns per-task handles.

        The caller (a worker holding the leases) waits on the handles and
        acks/nacks per task — the engine never touches the broker."""
        keyfn = getattr(self.runtime, "affinity_key", None)
        pendings = [PendingTask(t, keyfn(t) if keyfn is not None else None)
                    for t in tasks]
        if not pendings:
            return pendings
        with self._cv:
            if self._closed:
                raise EngineClosed("engine is closed")
            self._ensure_thread_locked()
            now = time.monotonic()
            for p in pendings:
                p.submitted_at = now
            if self._t0 is None:
                self._t0 = now
            if self._last_submit is not None:
                gap = now - self._last_submit
                self._ema_gap = gap if self._ema_gap is None else (
                    self._GAP_ALPHA * gap
                    + (1.0 - self._GAP_ALPHA) * self._ema_gap)
            self._last_submit = now
            if not self._buf:
                self._deadline = now + self.max_wait
            self._buf.extend(pendings)
            self._stats["submitted"] += len(pendings)
            self._cv.notify_all()
        return pendings

    def flush(self) -> None:
        """Dispatch the current partial buffer without waiting for the
        deadline (drain/shutdown path).

        The request is STICKY when the buffer is empty: a worker may hold
        leased-but-not-yet-submitted tasks at the instant shutdown calls
        this (the lease->submit window), and dropping the request would
        strand that batch — the worker parks on its handles for the full
        deadline while shutdown's join times out.  Persisting the flag
        makes the next submitted batch dispatch immediately; it is
        cleared the moment a dispatch empties the buffer."""
        with self._cv:
            self._flush_asked = True
            self._cv.notify_all()

    # -- dispatcher ----------------------------------------------------------
    def _front_group_locked(self) -> List[PendingTask]:
        """The oldest task's affinity group — the only tasks the next
        dispatch may take (two keys never share a fused launch)."""
        key = self._buf[0].key
        return [p for p in self._buf if p.key == key]

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._buf and not self._closed:
                    self._cv.wait()
                if not self._buf and self._closed:
                    return
                # size-or-deadline wait (closed/flush cut it short); with
                # adaptation, a buffer whose feed has gone quiet flushes
                # after a short idle grace instead of the full window
                while (len(self._front_group_locked()) < self.max_batch
                       and not self._closed and not self._flush_asked):
                    cutoff = self._deadline
                    if (self.adaptive and self._ema_gap is not None
                            and self._ema_gap > self.max_wait
                            and self._last_submit is not None):
                        cutoff = min(cutoff,
                                     self._last_submit + self._idle_grace)
                    remaining = cutoff - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                group = self._front_group_locked()
                if len(group) >= self.max_batch:
                    reason = "size_flushes"
                elif self._flush_asked or self._closed:
                    reason = "forced_flushes"
                elif time.monotonic() < self._deadline:
                    reason = "adaptive_flushes"
                else:
                    reason = "deadline_flushes"
                batch = group[:self.max_batch]
                taken = set(map(id, batch))
                self._buf = [p for p in self._buf if id(p) not in taken]
                if self._buf:
                    if (len(batch) < self.max_batch
                            and any(p.key != batch[0].key
                                    for p in self._buf)):
                        # a second study/simulator was waiting: this batch
                        # dispatched short rather than interleave keys
                        self._stats["affinity_splits"] += 1
                    self._deadline = self._buf[0].submitted_at + self.max_wait
                else:
                    self._flush_asked = False
            self._execute(batch, reason)

    def _ensure_writer(self) -> Queue:
        if self._wq is None:
            self._wq = Queue(maxsize=2)  # bounded: dispatch stalls if the
            self._writer = threading.Thread(  # writer falls 2 batches behind
                target=self._writer_loop, daemon=True,
                name="merlin-engine-writer")
            self._writer.start()
        return self._wq

    def _busy_time_locked(self, now: float) -> float:
        """Cumulative dispatch-thread busy seconds up to ``now`` (the
        writer samples this at finalize start/end to measure overlap)."""
        extra = (now - self._busy_since) if self._busy_since is not None \
            else 0.0
        return self._busy_accum + extra

    def _execute(self, batch: List[PendingTask], reason: str) -> None:
        t0 = time.monotonic()
        deferred = getattr(self.runtime, "execute_real_many_deferred", None)
        if deferred is not None:
            # pipelined path: dispatch device compute here, hand the host
            # sync + bundle writes + once-markers (finalize) to the writer
            # thread, and loop straight to the next batch.  Handles resolve
            # only after finalize — ack-after-durable is preserved.
            with self._cv:
                self._busy_since = t0
            finalize = None
            try:
                finalize = deferred([p.task for p in batch])
            except BaseException:
                pass  # compute-stage failure: writer runs per-task fallback
            finally:
                now = time.monotonic()
                with self._cv:
                    self._busy_accum += now - self._busy_since
                    self._busy_since = None
            self._ensure_writer().put((batch, finalize, reason, now - t0))
            return
        outcomes = self._run_fallback_capable(batch, fused=True)
        self._finish(batch, outcomes, reason,
                     exec_dt=time.monotonic() - t0)

    def _run_fallback_capable(
            self, batch: List[PendingTask],
            fused: bool) -> List[Optional[BaseException]]:
        """Execute a batch with per-task isolation on failure.

        A handle must NEVER resolve as success unless its task's execution
        actually returned — tasks left at the default outcome (e.g. a step
        fn raising SystemExit aborts both attempts) come back as failures,
        so the worker nacks them for redelivery instead of acking work
        that never ran (at-least-once preserved)."""
        outcomes: List[Optional[BaseException]] = [
            RuntimeError("engine dispatcher aborted before this task "
                         "executed")] * len(batch)
        try:
            if fused:
                self.runtime.execute_real_many([p.task for p in batch])
                return [None] * len(batch)
        except BaseException:
            pass  # fused path failed: isolate the poison task below
        # per-task retry (already-completed tasks no-op on once-markers)
        for i, p in enumerate(batch):
            try:
                self.runtime.execute_real(p.task)
                outcomes[i] = None
            except BaseException as e:
                outcomes[i] = e
        return outcomes

    def _writer_loop(self) -> None:
        while True:
            item = self._wq.get()
            if item is None:
                return
            batch, finalize, reason, exec_dt = item
            tf0 = time.monotonic()
            with self._cv:
                b0 = self._busy_time_locked(tf0)
            if finalize is not None:
                try:
                    finalize()
                    outcomes: List[Optional[BaseException]] = \
                        [None] * len(batch)
                except BaseException:
                    finalize = None  # fall through to per-task isolation
            if finalize is None:
                outcomes = self._run_fallback_capable(batch, fused=False)
            tf1 = time.monotonic()
            with self._cv:
                # overlap = dispatch-thread busy time during this finalize:
                # the write seconds hidden behind the next batch's compute
                overlap = self._busy_time_locked(tf1) - b0
                self._stats["deferred_batches"] += 1
                self._stats["write_s"] += tf1 - tf0
                self._stats["write_overlap_s"] += max(0.0, overlap)
            self._finish(batch, outcomes, reason,
                         exec_dt=exec_dt + (tf1 - tf0))

    def _finish(self, batch: List[PendingTask],
                outcomes: List[Optional[BaseException]], reason: str,
                exec_dt: float) -> None:
        failed = sum(1 for e in outcomes if e is not None)
        with self._cv:
            s = self._stats
            s["batches"] += 1
            s[reason] += 1
            s["executed"] += len(batch)
            s["failed_tasks"] += failed
            s["max_batch_seen"] = max(s["max_batch_seen"], len(batch))
            s["exec_s"] += exec_dt
            hist = s["batch_hist"]
            hist[len(batch)] = hist.get(len(batch), 0) + 1
        # resolve OUTSIDE the lock, always — a handle left unresolved
        # would hang its worker forever
        for p, err in zip(batch, outcomes):
            p._resolve(err)

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Counters plus derived figures (see module docstring)."""
        with self._cv:
            s = dict(self._stats)
            s["batch_hist"] = dict(s["batch_hist"])
            s["buffered"] = len(self._buf)
            s["ema_gap_ms"] = (self._ema_gap * 1000.0
                               if self._ema_gap is not None else None)
            t0 = self._t0
        s["avg_batch"] = (s["executed"] / s["batches"]) if s["batches"] else 0.0
        up = (time.monotonic() - t0) if t0 is not None else 0.0
        s["uptime_s"] = up
        s["utilization"] = (s["exec_s"] / up) if up > 0 else 0.0
        return s

    def __enter__(self) -> "ExecutionEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# continuous batching for inference requests (the serving tier)
# ---------------------------------------------------------------------------

def _pow2_bucket(n: int) -> int:
    """Smallest power-of-two >= n (mirrors ``ensemble.bucket_for`` without
    importing the jax-backed module — the batcher itself is pure threads)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


class ServeRequest:
    """One inference request's completion handle.

    Resolved by the batcher thread with either ``result`` set (success),
    or ``error`` holding :class:`DeadlineExpired` / :class:`EngineClosed`
    / the inference exception."""

    __slots__ = ("rows", "deadline", "seq", "event", "result", "error",
                 "submitted_at")

    def __init__(self, rows: np.ndarray, deadline: Optional[float],
                 seq: int):
        self.rows = rows
        self.deadline = deadline  # absolute monotonic time, or None
        self.seq = seq
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.submitted_at = time.monotonic()

    def done(self) -> bool:
        return self.event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.event.wait(timeout)

    def _resolve(self, result, error: Optional[BaseException]) -> None:
        self.result = result
        self.error = error
        self.event.set()


class ContinuousBatcher:
    """Continuous micro-batcher for surrogate inference requests.

    The workflow-side :class:`ExecutionEngine` batches by size-or-deadline
    because leased tasks are throughput work: waiting out ``max_wait`` for
    a fuller batch is free.  Serving is the opposite regime — every
    request carries a caller waiting on the wire — so this batcher never
    idles while work is queued.  The loop thread runs back-to-back
    launches; requests that arrive while batch N executes are admitted
    into batch N+1 at the next *bucket boundary* (the same power-of-two
    grid the ensemble jit cache compiles for doubles as the admission
    grid): the batch takes requests in deadline order until adding the
    next one would overflow ``max_batch_rows``, then keeps topping up
    only while the rows still fit inside the bucket the batch already
    pays padding for.  Fusion therefore comes from concurrency (as in
    vLLM's continuous batching), not from waiting — modulo a tiny
    adaptive admission window (``ADMISSION_FRAC`` of the EMA launch
    time, hard-capped at ``ADMISSION_CAP_S``) that lets a fused
    cohort's clients, which all resolved together and turn around one
    scheduler quantum apart, rejoin the same launch instead of
    degenerating into batches of one.

    * **Deadline-ordered admission.**  The queue is a min-heap on each
      request's absolute deadline (no deadline sorts last, FIFO within a
      tie), so under backlog the most urgent requests execute first.
    * **Per-request deadlines.**  A request whose deadline passes while
      still queued resolves with :class:`DeadlineExpired` *without
      executing* — the gateway maps it to 504.
    * **Load shedding.**  ``submit`` raises :class:`~repro_torch.core.queue.
      BrokerFull` (the broker tier's backpressure type — one shed
      vocabulary across the system) when ``max_inflight`` requests are
      already waiting; the gateway maps it to 429.
    * **Naive mode** (``naive=True``) admits exactly one request per
      launch — the flush-per-request baseline the serving benchmark
      A/Bs against.

    ``infer_fn(rows)`` receives a float32 ``(n, d)`` block spanning the
    whole fused batch and may return an array, a tuple of arrays, or a
    dict of arrays, each with leading dimension ``n``; the batcher slices
    the per-request spans back out.
    """

    # adaptive admission window: after the first request of a batch is
    # seen, hold admission open for this fraction of the EMA launch time
    # (hard-capped) so peers mid-turnaround join the same launch.  A
    # zero-wait loop degenerates to one-request batches whenever client
    # turnaround skew rivals the launch time (all of a fused batch's
    # clients resolve together, then trickle back one scheduler quantum
    # apart — the first arrival would launch alone, and the pattern
    # locks in).  Scaling the window to the launch itself keeps the
    # added latency second-order: fast models wait microseconds, slow
    # models amortize a few ms against tens.
    ADMISSION_FRAC = 1.0
    ADMISSION_CAP_S = 0.050
    # the window only engages when there is evidence of concurrency —
    # more than one request already queued, or recent batches fused —
    # so a lone steady client never pays it
    FUSION_ENGAGE = 1.5

    def __init__(self, infer_fn: Callable, max_batch_rows: int = 256,
                 max_inflight: int = 64, naive: bool = False):
        self.infer_fn = infer_fn
        self.max_batch_rows = max(1, int(max_batch_rows))
        self.max_inflight = max(1, int(max_inflight))
        self.naive = bool(naive)
        self._cv = threading.Condition()
        self._heap: list = []  # (deadline-or-inf, seq, ServeRequest)
        self._seq = 0
        self._active = 0  # requests inside the currently-executing batch
        self._launch_ema = 0.0  # EMA of launch seconds (admission window)
        self._fusion_ema = 1.0  # EMA of requests/batch (window trigger)
        self._draining = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._stats: Dict[str, object] = {
            "submitted": 0, "completed": 0, "failed": 0, "shed": 0,
            "expired": 0, "batches": 0, "rows": 0, "padded_rows": 0,
            "exec_s": 0.0, "batch_requests_hist": {}, "occupancy_hist": {},
        }

    # -- submission ----------------------------------------------------------
    def submit(self, rows, deadline_s: Optional[float] = None) -> ServeRequest:
        """Queue an inference request; returns its completion handle.

        ``deadline_s`` is the per-request latency budget in seconds from
        now; once it passes, a still-queued request is dropped unexecuted.
        Raises ``BrokerFull`` when the admission queue is at
        ``max_inflight`` (shed *before* admission — the queue bound is
        also the worst-case queueing delay bound) and ``EngineClosed``
        when draining or closed."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2 or len(rows) == 0:
            raise ValueError(f"rows must be a non-empty (n, d) block, "
                             f"got shape {rows.shape}")
        deadline = (time.monotonic() + float(deadline_s)
                    if deadline_s is not None else None)
        with self._cv:
            if self._closed or self._draining:
                raise EngineClosed("serve batcher is "
                                   + ("closed" if self._closed
                                      else "draining"))
            if len(self._heap) >= self.max_inflight:
                self._stats["shed"] += 1
                raise BrokerFull(
                    f"admission queue full: {len(self._heap)} requests "
                    f"waiting (max_inflight={self.max_inflight})")
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="merlin-serve-batcher")
                self._thread.start()
            self._seq += 1
            req = ServeRequest(rows, deadline, self._seq)
            key = deadline if deadline is not None else math.inf
            heapq.heappush(self._heap, (key, req.seq, req))
            self._stats["submitted"] += 1
            self._cv.notify_all()
        return req

    # -- batch formation + execution -----------------------------------------
    def _admit_locked(self, now: float):
        """Pop expired requests and the next batch (deadline order)."""
        expired, batch, rows_total = [], [], 0
        while self._heap:
            _, _, req = self._heap[0]
            if req.deadline is not None and req.deadline <= now:
                heapq.heappop(self._heap)
                expired.append(req)
                self._stats["expired"] += 1
                continue
            n = len(req.rows)
            if batch:
                if self.naive:
                    break  # flush-per-request baseline: one request/launch
                # bucket-boundary admission: grow freely up to
                # max_batch_rows, then only while the padding the batch
                # already pays for absorbs the extra rows
                if (rows_total + n > self.max_batch_rows
                        and rows_total + n > _pow2_bucket(rows_total)):
                    break
            heapq.heappop(self._heap)
            batch.append(req)
            rows_total += n
        self._active = len(batch)
        return expired, batch, rows_total

    @staticmethod
    def _slice_out(out, sl: slice):
        if isinstance(out, dict):
            return {k: v[sl] for k, v in out.items()}
        if isinstance(out, (tuple, list)):
            return type(out)(v[sl] for v in out)
        return out[sl]

    def _execute(self, batch: List[ServeRequest], rows_total: int) -> None:
        X = batch[0].rows if len(batch) == 1 else \
            np.concatenate([r.rows for r in batch])
        t0 = time.monotonic()
        resolved: List = []
        try:
            out = self.infer_fn(X)
            lo = 0
            for req in batch:
                resolved.append((req, self._slice_out(
                    out, slice(lo, lo + len(req.rows))), None))
                lo += len(req.rows)
        except BaseException:
            # isolate the poison request: batch-mates still complete
            for req in batch:
                try:
                    resolved.append((req, self.infer_fn(req.rows), None))
                except BaseException as e:
                    resolved.append((req, None, e))
        dt = time.monotonic() - t0
        bucket = _pow2_bucket(rows_total)
        with self._cv:
            self._launch_ema = (dt if self._launch_ema == 0.0
                                else 0.7 * self._launch_ema + 0.3 * dt)
            self._fusion_ema = (0.7 * self._fusion_ema
                                + 0.3 * len(batch))
            s = self._stats
            s["batches"] += 1
            s["rows"] += rows_total
            s["padded_rows"] += bucket - rows_total
            s["exec_s"] += dt
            s["completed"] += sum(1 for _, _, e in resolved if e is None)
            s["failed"] += sum(1 for _, _, e in resolved if e is not None)
            h = s["batch_requests_hist"]
            h[len(batch)] = h.get(len(batch), 0) + 1
            o = s["occupancy_hist"]
            o[bucket] = o.get(bucket, 0) + 1
            self._active = 0
            self._cv.notify_all()  # drain() waiters
        for req, result, err in resolved:
            req._resolve(result, err)

    def _queued_rows_locked(self) -> int:
        return sum(len(r.rows) for _, _, r in self._heap)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._closed:
                    self._cv.wait()
                if not self._heap and self._closed:
                    return
                window = min(self.ADMISSION_CAP_S,
                             self.ADMISSION_FRAC * self._launch_ema)
                if (window > 0 and not self.naive and not self._closed
                        and (len(self._heap) > 1
                             or self._fusion_ema >= self.FUSION_ENGAGE)):
                    # hold the window only while the queue can still
                    # grow: at max_inflight requests (every closed-loop
                    # client is back; submit would shed anyway) or a full
                    # max_batch_rows there is nothing left to wait for
                    until = time.monotonic() + window
                    while (len(self._heap) < self.max_inflight
                           and self._queued_rows_locked()
                           < self.max_batch_rows
                           and not self._closed):
                        left = until - time.monotonic()
                        if left <= 0:
                            break
                        self._cv.wait(left)
                expired, batch, rows_total = \
                    self._admit_locked(time.monotonic())
            for req in expired:
                req._resolve(None, DeadlineExpired(
                    "deadline passed before admission "
                    f"(queued {time.monotonic() - req.submitted_at:.3f}s)"))
            if batch:
                self._execute(batch, rows_total)

    # -- lifecycle -----------------------------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting new requests (submit raises EngineClosed) and
        wait until every already-admitted request has resolved.  Returns
        True when the queue fully drained within the timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self._draining = True
            self._cv.notify_all()
            while self._heap or self._active:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.1))
        return True

    def close(self, timeout: float = 10.0) -> None:
        """Stop the loop thread; the backlog executes first (pair with
        ``drain()`` for a bounded graceful stop)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        with self._cv:
            leftovers, self._heap = [r for _, _, r in self._heap], []
        for req in leftovers:
            req._resolve(None, EngineClosed("batcher closed before "
                                            "execution"))

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._cv:
            s = dict(self._stats)
            s["batch_requests_hist"] = dict(s["batch_requests_hist"])
            s["occupancy_hist"] = dict(s["occupancy_hist"])
            s["queued"] = len(self._heap)
        s["avg_requests_per_batch"] = (
            (s["completed"] + s["failed"]) / s["batches"]
            if s["batches"] else 0.0)
        return s

    def __enter__(self) -> "ContinuousBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
