"""Workers (``merlin run-workers``): the consumer side of the model.

Workers are deliberately decoupled from the work (paper Sec. 2.2 / Fig. 6):
they attach to a broker, lease whatever is queued — generation tasks get
expanded, real tasks get executed — and can join or leave at any time
("surge computing": ``WorkerPool.scale()`` mid-study adds capacity exactly
like a new batch allocation attaching to the Rabbit server).

Named-queue routing: a worker constructed with ``queues=("sims",)`` only
ever leases from the ``sims`` queue — the paper's routing-key mechanism for
pinning simulation vs. ML workers to disjoint streams.  ``queues=None``
(the default) subscribes to everything.  ``batch`` > 1 leases several tasks
per broker round-trip (``get_many``/``ack_many``), which matters for the
FileBroker where each claim is a filesystem rename.

Fault injection (``failure_rate``) and the broker's visibility timeout
together reproduce the paper's resilience story: a worker that "dies"
mid-task simply never acks; the task is redelivered and, because real-task
execution is idempotent (journal/once markers), re-running is safe.  Retry
caps come from one shared :class:`~repro_torch.core.resilience.RetryPolicy`, so
both broker backends age out poison tasks identically.

Remote brokers: when the runtime's broker is a NetBroker, a broker-server
restart surfaces here as :class:`~repro_torch.core.queue.BrokerUnavailable` after
the client's reconnect window.  Workers treat it as transient — back off,
keep polling, and effectively resubscribe once the server returns
(subscriptions are stateless: the queue list rides on every ``get_many``).
Leases stranded by the outage expire server-side and redeliver; completed
work re-acked after a reconnect is a no-op (acks are idempotent).  Acks
that hit the outage are retried after the reconnect instead of dropped
(``stats["acks_retried"]``) — far cheaper than letting a finished batch's
leases all expire and re-execute.

Backpressure: a bounded broker queue (``max_queue_depth``) surfaces as
:class:`~repro_torch.core.queue.BrokerFull` during generation-task expansion.
Workers throttle — hold the gen lease, back off ``throttle_backoff``,
retry (``stats["throttled"]``) — and only after ``max_throttle_retries``
give the task back via the normal nack path.  Expansion never dies over a
full queue.

Heartbeats: each worker pings ``broker.heartbeat(consumer_id, queues)``
every ``heartbeat_interval`` seconds, so ``broker.stats["consumers"]``
reports live consumers per queue across all processes.

Execution engine: by default every WorkerPool routes its real fn-step
tasks through the runtime's shared :class:`~repro_torch.core.engine.
ExecutionEngine` — workers become pure lease pumps (lease, submit, wait
for per-task outcomes, ack), and the engine's deadline-based
micro-batcher coalesces compatible tasks across get_many batches, across
workers, and across queues into single fused device launches.  Pass
``engine=None`` to keep the pre-engine behavior (per-worker, per-batch
coalescing inside the worker thread), or an ExecutionEngine instance to
share one scheduler between pools explicitly.
"""
from __future__ import annotations

import os
import random
import socket
import threading
import time
from typing import List, Optional, Sequence

from repro_torch.core import hierarchy as H
from repro_torch.core.engine import EngineClosed, ExecutionEngine
from repro_torch.core.queue import (BrokerError, BrokerFull, Lease, Task,
                              dlq_queue_name)
from repro_torch.core.resilience import BackoffPolicy, RetryPolicy
from repro_torch.core.runtime import MerlinRuntime


class WorkerError(RuntimeError):
    pass


class Worker(threading.Thread):
    def __init__(self, runtime: MerlinRuntime, worker_id: str,
                 stop_event: threading.Event, failure_rate: float = 0.0,
                 seed: int = 0, poll_timeout: float = 0.05,
                 queues: Optional[Sequence[str]] = None, batch: int = 1,
                 retry_policy: Optional[RetryPolicy] = None,
                 heartbeat_interval: float = 2.0,
                 throttle_backoff: float = 0.2,
                 max_throttle_retries: int = 50,
                 engine: Optional[ExecutionEngine] = None,
                 broker_backoff: Optional[BackoffPolicy] = None):
        super().__init__(daemon=True, name=f"merlin-worker-{worker_id}")
        self.runtime = runtime
        self.worker_id = worker_id
        self.stop_event = stop_event
        self.failure_rate = failure_rate
        self.rng = random.Random(seed)
        self.poll_timeout = poll_timeout
        self.queues = queues
        self.batch = max(1, batch)
        self.retry_policy = retry_policy or RetryPolicy()
        self.heartbeat_interval = heartbeat_interval
        self.throttle_backoff = throttle_backoff
        self.max_throttle_retries = max_throttle_retries
        self.engine = engine
        # host-qualified: workers in different allocations (nodes) sharing
        # one broker must not collide in the heartbeat registry, or
        # stats["consumers"] undercounts the fleet
        self.consumer_id = f"{socket.gethostname()}:{os.getpid()}:{self.name}"
        self.stats = {"gen": 0, "real": 0, "failed": 0, "broker_retries": 0,
                      "acks_retried": 0, "throttled": 0, "acks_dropped": 0,
                      "dead_lettered": 0, "skipped": 0, "halted_drained": 0}
        self.first_real_at: Optional[float] = None
        self._last_hb = 0.0
        # jittered-exponential backoff for broker outages (replaces the old
        # fixed 0.2 s sleep); the streak resets on any successful lease call
        self.broker_backoff = broker_backoff or BackoffPolicy(
            base=0.05, cap=1.0, rng=self.rng)
        self._broker_err_streak = 0
        # studies known halted: positive cache so the drain check is one
        # set lookup per task instead of a counter stat
        self._halted_studies: set = set()
        # acks that hit a broker blip: retried on later iterations instead
        # of being dropped (satellite: a transient error after a successful
        # batch must not force N lease-expiry re-executions)
        self._pending_acks: List[str] = []

    _MAX_PENDING_ACKS = 10_000  # beyond this the leases have long expired
    _PUT_CHUNK = 64  # children per put_many during gen expansion

    def _heartbeat(self, broker) -> None:
        """Advisory liveness ping: the broker's stats["consumers"] view."""
        now = time.monotonic()
        if now - self._last_hb < self.heartbeat_interval:
            return
        self._last_hb = now
        hb = getattr(broker, "heartbeat", None)
        if hb is None:
            return  # non-protocol broker (a test stub): skip, don't die
        try:
            hb(self.consumer_id, self.queues)
        except BrokerError:
            pass  # broker blip: the next lease attempt handles backoff

    def _flush_acks(self, broker, fresh: List[str]) -> None:
        """Ack ``fresh`` plus anything a previous iteration failed to ack.

        Acks are idempotent and leases are broker-held, so retrying stale
        tags after a reconnect is safe — and FAR cheaper than letting every
        lease of a completed batch expire and re-execute (idempotently but
        wastefully) on another worker."""
        retried = len(self._pending_acks)
        self._pending_acks.extend(fresh)
        if not self._pending_acks:
            return
        try:
            broker.ack_many(self._pending_acks)
        except BrokerError:
            self.stats["broker_retries"] += 1
            # keep them for the next iteration; cap the backlog — anything
            # old enough to overflow it has already expired server-side.
            # The drop is journaled, never silent: operators auditing a
            # long outage can see exactly which leases were abandoned to
            # visibility-timeout redelivery.
            overflow = len(self._pending_acks) - self._MAX_PENDING_ACKS
            if overflow > 0:
                dropped = self._pending_acks[:overflow]
                self.stats["acks_dropped"] += overflow
                self.runtime.journal.append(
                    {"ev": "acks_dropped", "worker": self.worker_id,
                     "n": overflow, "tags": dropped[:100]})
                del self._pending_acks[:overflow]
        else:
            self.stats["acks_retried"] += retried
            self._pending_acks.clear()

    def run(self) -> None:
        broker = self.runtime.broker
        while not self.stop_event.is_set():
            self._heartbeat(broker)
            if self._pending_acks:
                self._flush_acks(broker, [])
            try:
                leases = broker.get_many(self.batch,
                                         timeout=self.poll_timeout,
                                         queues=self.queues)
            except BrokerError:
                # broker down (BrokerUnavailable) or a transient server-side
                # failure relayed as a structured error: back off and keep
                # polling — a dead worker thread is strictly worse, and once
                # the broker heals we lease again (reconnect-and-resubscribe;
                # the subscription is stateless, it rides on every get_many)
                self.stats["broker_retries"] += 1
                self.stop_event.wait(
                    self.broker_backoff.delay(self._broker_err_streak))
                self._broker_err_streak += 1
                continue
            self._broker_err_streak = 0
            if not leases:
                continue
            leases = self._drop_halted(leases, broker)
            if not leases:
                continue
            acks: List[str] = []
            # Coalesced execution: real leases from one get_many batch are
            # handed to the runtime together, which fuses contiguous sample
            # ranges into single device launches (execute_real_many).  Gen
            # tasks and injected failures keep the per-lease path.
            reals: List[Lease] = []
            for lease in leases:
                if lease.task.kind == "real":
                    if self.failure_rate and \
                            self.rng.random() < self.failure_rate:
                        # injected death: same bookkeeping as a raised
                        # WorkerError in the per-lease path
                        self._record_failure(lease, broker)
                    else:
                        reals.append(lease)
                    continue
                if self._run_one(lease, broker):
                    acks.append(lease.tag)
            if reals:
                if self.first_real_at is None:
                    self.first_real_at = time.monotonic()
                acks.extend(self._execute_reals(reals, broker))
            if acks:
                self._flush_acks(broker, acks)

    def _drop_halted(self, leases: List[Lease], broker) -> List[Lease]:
        """The passive drain for ``on_failure: halt_study``: tasks of a
        halted study are acked away unexecuted.  Positives are cached so
        steady-state drain costs one set lookup per task."""
        keep: List[Lease] = []
        drained: List[str] = []
        for lease in leases:
            study = lease.task.payload.get("study") \
                if isinstance(lease.task.payload, dict) else None
            if isinstance(study, str) and (
                    study in self._halted_studies
                    or self.runtime.study_halted(study)):
                self._halted_studies.add(study)
                drained.append(lease.tag)
            else:
                keep.append(lease)
        if drained:
            self.stats["halted_drained"] += len(drained)
            self._flush_acks(broker, drained)
        return keep

    def _execute_reals(self, reals: List[Lease], broker) -> List[str]:
        """Run a lease batch's real tasks; returns the ackable tags.

        Engine path (the default): fusable tasks — sample-parallel nodes
        whose :class:`~repro_torch.core.handlers.ExecutionHandler` is
        in-process — go to the shared micro-batching scheduler and this
        thread waits for the per-task outcomes: cross-worker fusion
        happens there, and a failed task comes back as ITS handle's error
        while batch-mates succeed.  Everything else — subprocess and
        scheduler-job handlers, funnel nodes, unknown studies, or all
        tasks when ``engine=None`` — runs in-thread (fusing within this
        lease batch only, per-lease fallback on failure).  The worker
        never inspects fn vs cmd itself: ``runtime.coalescable`` consults
        the node's handler, so new handlers slot in without touching
        this dispatch."""
        acks: List[str] = []
        if self.engine is not None:
            # only fusable work goes through the shared dispatcher;
            # out-of-process handlers (subprocess, scheduler jobs) and
            # funnel nodes stay in THIS thread, so a pool of N workers
            # still runs N subprocess simulations concurrently and a slow
            # command step cannot head-of-line-block fn-step batches
            fusable, direct = [], []
            for lease in reals:
                (fusable if self.runtime.coalescable(lease.task)
                 else direct).append(lease)
            pendings = None
            if fusable:
                try:
                    pendings = self.engine.submit_many(
                        [l.task for l in fusable])
                except EngineClosed:
                    direct = reals  # pool tearing down: all in-thread
            if direct:
                acks.extend(self._execute_reals_inline(direct, broker))
            if pendings is not None:
                for lease, p in zip(fusable, pendings):
                    # dispatch is deadline-bounded (max_wait_ms), so this
                    # wait is short unless the device itself is busy
                    p.wait()
                    if isinstance(p.error, EngineClosed):
                        continue  # never executed: lease expiry redelivers
                    if p.error is None:
                        self.stats["real"] += 1
                        acks.append(lease.tag)
                    else:
                        self._record_failure(lease, broker)
            return acks
        return acks + self._execute_reals_inline(reals, broker)

    def _execute_reals_inline(self, reals: List[Lease],
                              broker) -> List[str]:
        """The in-thread path: fuse within this lease batch only."""
        acks: List[str] = []
        try:
            self.runtime.execute_real_many([l.task for l in reals])
            self.stats["real"] += len(reals)
            acks.extend(l.tag for l in reals)
        except Exception:
            # a task in the batch failed even under the runtime's
            # per-task fallback: re-run each lease individually so
            # ack/nack/retry accounting stays per-task
            for lease in reals:
                if self._run_one(lease, broker):
                    acks.append(lease.tag)
        return acks

    def _run_one(self, lease: Lease, broker) -> bool:
        """Per-lease dispatch with failure accounting; True if ackable."""
        try:
            self._dispatch(lease.task)
        except Exception:
            self._record_failure(lease, broker)
            return False
        return True

    def _record_failure(self, lease: Lease, broker) -> None:
        """Failure bookkeeping + the per-step ``on_failure`` policy.

        Every mode first consumes the retry budget — the step's
        ``retries:`` when the runtime knows the study, else this worker's
        RetryPolicy — and the mode's action applies only at exhaustion:
        ``retry`` acks the poison away (the crawler's job from then on),
        ``dead_letter`` moves it to ``dlq.<queue>``, ``skip`` marks the
        bundle complete so children unlock, ``halt_study`` stops the whole
        study and the fleet drains its tasks."""
        self.stats["failed"] += 1
        task = lease.task
        self.runtime.journal.append(
            {"ev": "task_failed", "task": task.id, "kind": task.kind,
             "payload": {k: v for k, v in task.payload.items()
                         if k != "spec"}})
        policy = self.runtime.failure_policy(task)
        if policy is None:
            mode, retry_ok = "retry", self.retry_policy.should_retry(task)
        else:
            mode, retry_ok = policy[0], task.retries < policy[1]
        try:
            if retry_ok:
                broker.nack(lease.tag)
                return
            if mode == "dead_letter":
                self._dead_letter(lease, broker)
            elif mode == "skip" and task.kind == "real":
                # gen tasks can't skip-complete (no bundle of their own);
                # they fall through to the poison path below
                self.runtime.complete_skipped(task)
                broker.ack(lease.tag)
                self.stats["skipped"] += 1
            elif mode == "halt_study":
                study = task.payload.get("study") \
                    if isinstance(task.payload, dict) else None
                if isinstance(study, str):
                    self.runtime.halt_study(
                        study, reason=f"task {task.id} exhausted retries")
                    self._halted_studies.add(study)
                broker.ack(lease.tag)
                self.runtime.note_failure(task)
            else:  # "retry" exhausted: poison, give up, leave to crawler
                broker.ack(lease.tag)
                if task.kind == "real":
                    # surface the give-up in the persisted DAG state so
                    # merlin-status shows the node as failed, not running
                    self.runtime.note_failure(task)
        except BrokerError:
            # lease expiry redelivers with retries bumped — same outcome
            self.stats["broker_retries"] += 1

    def _dead_letter(self, lease: Lease, broker) -> None:
        """Move an exhausted task to its queue's ``dlq.`` twin.  The clone
        is put BEFORE the original is acked: a crash in between leaves a
        duplicate (at-least-once, harmless), never a lost task."""
        task = lease.task
        broker.put(Task(id=task.id, kind=task.kind,
                        payload=dict(task.payload), priority=task.priority,
                        queue=dlq_queue_name(task.queue),
                        retries=task.retries))
        broker.ack(lease.tag)
        self.stats["dead_lettered"] += 1
        self.runtime.journal.append(
            {"ev": "task_dead_lettered", "task": task.id,
             "queue": task.queue, "dlq": dlq_queue_name(task.queue)})
        if task.kind == "real":
            self.runtime.note_failure(task)

    def _dispatch(self, task: Task) -> None:
        # injected failure: worker "dies" on this task (no ack, no effect)
        if self.failure_rate and self.rng.random() < self.failure_rate:
            raise WorkerError("injected failure")
        if task.kind == "gen":
            children = H.expand(task)
            # chunked puts: typical fanouts (<= _PUT_CHUNK) stay one
            # round-trip, and when backpressure strikes, a retry re-sends
            # at most one chunk — not the whole expansion — so duplicates
            # of already-admitted children stay bounded instead of
            # re-flooding the very queue whose bound tripped
            attempt = 0
            for lo in range(0, len(children), self._PUT_CHUNK):
                chunk = children[lo:lo + self._PUT_CHUNK]
                while True:
                    try:
                        self.runtime.broker.put_many(chunk)
                        break
                    except BrokerFull:
                        # backpressure: the downstream queue is at its
                        # bound.  Throttle expansion instead of dying —
                        # hold the gen lease, back off, retry this chunk
                        # (re-putting an already-admitted child duplicates
                        # it, which is safe: delivery is at-least-once and
                        # execution idempotent)
                        self.stats["throttled"] += 1
                        attempt += 1
                        if attempt >= self.max_throttle_retries or \
                                self.stop_event.wait(self.throttle_backoff):
                            # give the queue back instead of spinning
                            # forever: the raised error nacks this gen
                            # task, so expansion resumes (on any worker,
                            # re-enqueueing some duplicate children) once
                            # the flood drains
                            raise WorkerError(
                                "gen expansion backpressured past retry "
                                "budget")
            self.stats["gen"] += 1
        elif task.kind == "real":
            if self.first_real_at is None:
                self.first_real_at = time.monotonic()
            self.runtime.execute_real(task)
            self.stats["real"] += 1
        else:
            raise WorkerError(f"unknown task kind {task.kind}")


class WorkerPool:
    """An elastic pool of worker threads sharing one broker.

    ``queues`` pins every worker in the pool to the named queues (None =
    all); ``batch`` sets the per-poll lease batch size.

    ``engine`` selects the execution path for real fn-step tasks:

    * ``"auto"`` (default) — the runtime's shared
      :class:`~repro_torch.core.engine.ExecutionEngine`: every pool on the
      runtime feeds one micro-batching scheduler, so fusion spans
      workers, pools, and queues.  ``engine_cfg`` (``max_batch``,
      ``max_wait_ms``) parameterizes it when this pool creates it.
    * ``None``/``False`` — the legacy in-thread path (coalescing only
      within one worker's lease batch).
    * an :class:`~repro_torch.core.engine.ExecutionEngine` instance — share an
      explicitly-constructed scheduler.
    """

    def __init__(self, runtime: MerlinRuntime, n_workers: int = 2,
                 failure_rate: float = 0.0, seed: int = 0,
                 queues: Optional[Sequence[str]] = None, batch: int = 1,
                 retry_policy: Optional[RetryPolicy] = None,
                 engine="auto", engine_cfg: Optional[dict] = None):
        self.runtime = runtime
        self.stop_event = threading.Event()
        self.failure_rate = failure_rate
        self.seed = seed
        self.queues = queues
        self.batch = batch
        self.retry_policy = retry_policy
        if engine == "auto":
            self.engine = runtime.shared_engine(**(engine_cfg or {}))
        elif engine in (None, False):
            self.engine = None
        else:
            self.engine = engine.attach()
        self.workers: List[Worker] = []
        self.scale(n_workers)

    def scale(self, n_more: int) -> None:
        """Surge: attach n_more workers to the running study."""
        base = len(self.workers)
        for i in range(n_more):
            w = Worker(self.runtime, f"w{base + i}", self.stop_event,
                       failure_rate=self.failure_rate,
                       seed=self.seed + base + i,
                       queues=self.queues, batch=self.batch,
                       retry_policy=self.retry_policy,
                       engine=self.engine)
            w.start()
            self.workers.append(w)

    def drain(self, timeout: float = 120.0, poll: float = 0.02) -> bool:
        """Wait until the broker is idle (queue empty, nothing in flight).

        Once nothing is left to LEASE, kicks the engine's partial
        micro-batch out so tail-end tasks (fewer than ``max_batch`` under
        a long ``max_wait_ms``) execute now instead of waiting out the
        batching deadline — or, worse, their visibility timeout.  While
        the queue still holds work the engine is left alone: flushing
        mid-stream would shred the micro-batches drain exists to finish,
        not to defeat."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if self.runtime.broker.idle():
                    return True
                # gate on the LOCAL buffer count first: the extra qsize/
                # inflight round-trips (they fan out per shard on a
                # federation) are only worth paying when there is
                # something to flush
                if self.engine is not None:
                    buf = self.engine.buffered()
                    # flush only when every outstanding lease has reached
                    # the buffer (inflight == buffered): a worker that has
                    # leased tasks (qsize already 0) but not yet submitted
                    # them is about to make the batch FULLER — flushing
                    # around it would shred the very micro-batch drain
                    # exists to finish.  Leasing moves a task from ready
                    # to in-flight atomically, so this check is race-free;
                    # stale foreign leases merely defer to the engine's
                    # own deadline flush.
                    if buf > 0 and self.runtime.broker.qsize() == 0 \
                            and self.runtime.broker.inflight() <= buf:
                        self.engine.flush()
            except BrokerError:
                pass  # server restarting/erroring: not idle, keep waiting
            time.sleep(poll)
        return False

    def shutdown(self) -> None:
        if self.stop_event.is_set():
            return  # idempotent: explicit shutdown + context-manager exit
        # flush BEFORE stopping: workers may be parked on handles for a
        # partially-filled micro-batch; the forced dispatch resolves them
        # so every leased task is executed and acked, not stranded until
        # its visibility timeout redelivers it.  Skipped while OTHER
        # pools share the engine — force-dispatching THEIR accumulating
        # batches would shred cross-pool coalescing, and our own workers'
        # waits are deadline-bounded (max_wait_ms) regardless.
        if self.engine is not None and self.engine.refs <= 1:
            self.engine.flush()
        self.stop_event.set()
        for w in self.workers:
            w.join(timeout=5.0)
        if self.engine is not None:
            self.engine.detach()  # last pool out closes the dispatcher

    def stats(self) -> dict:
        agg = {"gen": 0, "real": 0, "failed": 0, "broker_retries": 0,
               "acks_retried": 0, "throttled": 0, "acks_dropped": 0,
               "dead_lettered": 0, "skipped": 0, "halted_drained": 0}
        for w in self.workers:
            for k in agg:
                agg[k] += w.stats[k]
        if self.engine is not None:
            agg["engine"] = self.engine.stats()
        return agg

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
