"""Stats-driven autoscaling for worker pools and federation shards.

Merlin's premise is that ensemble capacity flexes with the workload —
producers, workers, and brokers scale independently.  The brokers
already export everything a policy needs (per-queue depth, in-flight
leases, live consumers from the heartbeat registry, and the execution
engine's busy fraction); this module closes the loop:

* :class:`AutoscalePolicy` — the knobs: backlog-per-worker thresholds,
  pool sizing bounds, idle windows, cooldowns, and the total-backlog
  watermarks that trigger *shard-level* recommendations.

* :class:`Autoscaler` — a deterministic policy loop.  ``plan()`` samples
  the broker and produces a :class:`ScalePlan` (worker actions the loop
  can take itself + advisory shard join/leave recommendations);
  ``apply()`` executes the worker actions through a caller-supplied pool
  factory and sweeps dead members out of the federation membership file;
  ``step()`` is plan-then-apply.  All time flows through an injectable
  clock, so tests drive idle windows and cooldowns without sleeping.

Worker scale-*up* creates a new pool via ``pool_factory(n)``; scale-
*down* shuts down the most recently created pool (``WorkerPool.scale``
only grows, so the pool SET is the unit of elasticity).  Shard-level
actions are never taken autonomously — starting a broker server is a
deployment decision — they surface as recommendations that
``merlin-scale`` prints and an operator (or launcher script) acts on.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

__all__ = ["AutoscalePolicy", "ScaleAction", "ScalePlan", "Autoscaler"]


@dataclass(frozen=True)
class AutoscalePolicy:
    """Autoscaling thresholds (all advisory rates are per *poll*).

    Worker-level (the loop acts on these itself):

    * ``up_backlog_per_worker`` — scale up when pending tasks per unit of
      drain capacity exceed this.
    * ``pool_size`` — workers added per scale-up action (one new pool).
    * ``min_workers`` / ``max_workers`` — bounds on the worker count this
      autoscaler manages (externally-started workers are observed via
      consumer heartbeats but never touched).
    * ``down_idle_s`` — the broker must be continuously empty (no pending,
      no inflight) this long before a pool is retired.
    * ``cooldown_s`` — minimum spacing between applied worker actions, so
      a burst doesn't thrash pools up and down.
    * ``engine_busy_high`` — engine busy-fraction above which scale-down
      is vetoed and a non-empty backlog biases toward scale-up (the
      engine, not the workers, is the bottleneck signal).

    Shard-level (recommendations only):

    * ``shard_up_depth`` — total backlog above this recommends joining a
      shard to the federation.
    * ``shard_down_depth`` — total backlog at/below this (and nothing in
      flight) with more than one member recommends draining one out.
    * ``membership_ttl`` — heartbeat age past which ``apply()`` evicts a
      member from the membership file (dead-shard cleanup).
    """
    up_backlog_per_worker: float = 8.0
    pool_size: int = 2
    min_workers: int = 0
    max_workers: int = 16
    down_idle_s: float = 10.0
    cooldown_s: float = 5.0
    engine_busy_high: float = 0.85
    shard_up_depth: int = 5000
    shard_down_depth: int = 0
    membership_ttl: float = 15.0


@dataclass
class ScaleAction:
    """One planned action: ``workers_up``/``workers_down`` (actionable)
    or ``shard_join``/``shard_leave`` (advisory)."""
    kind: str
    n: int = 0
    reason: str = ""

    def to_doc(self) -> Dict[str, Any]:
        return {"kind": self.kind, "n": self.n, "reason": self.reason}


@dataclass
class ScalePlan:
    """The output of one policy evaluation: the observation snapshot it
    was derived from, the worker actions ``apply()`` would take, and the
    shard-level recommendations it would print."""
    at: float
    observed: Dict[str, Any]
    actions: List[ScaleAction] = field(default_factory=list)
    recommendations: List[ScaleAction] = field(default_factory=list)

    def to_doc(self) -> Dict[str, Any]:
        return {"observed": self.observed,
                "actions": [a.to_doc() for a in self.actions],
                "recommendations": [a.to_doc()
                                    for a in self.recommendations]}


class Autoscaler:
    """The policy loop: sample broker stats, plan, (optionally) apply.

    ``pool_factory(n)`` must return an object with ``shutdown()`` —
    typically ``lambda n: WorkerPool(runtime, n_workers=n, ...)``.
    Without a factory the loop still plans (``merlin-scale --plan``
    against a remote broker) but worker actions are reported, not taken.

    ``engine_stats`` is an optional zero-arg callable returning the
    execution-engine stats dict (the ``"utilization"`` busy fraction);
    ``membership_path`` points at the federation membership file so
    ``apply()`` can evict heartbeat-expired members and plan() can size
    shard recommendations against the live member count.
    """

    def __init__(self, broker, policy: Optional[AutoscalePolicy] = None,
                 pool_factory: Optional[Callable[[int], Any]] = None,
                 membership_path: Optional[str] = None,
                 engine_stats: Optional[Callable[[], Dict[str, Any]]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.broker = broker
        self.policy = policy or AutoscalePolicy()
        self.pool_factory = pool_factory
        self.membership_path = membership_path
        self.engine_stats = engine_stats
        self._clock = clock
        self.pools: List[Any] = []  # newest last; scale-down pops the tail
        self._pool_sizes: List[int] = []
        self._idle_since: Optional[float] = None
        self._last_action_at: Optional[float] = None

    # -- observation ---------------------------------------------------------
    def workers(self) -> int:
        """Workers under THIS autoscaler's management."""
        return sum(self._pool_sizes)

    def observe(self) -> Dict[str, Any]:
        """One stats sample, flattened to what the policy consumes."""
        stats = dict(self.broker.stats)
        consumers = {q: int(c) for q, c
                     in (stats.get("consumers") or {}).items()}
        queues = sorted(self.broker.queue_names())
        depth_by_q = {q: self.broker.qsize((q,)) for q in queues}
        obs: Dict[str, Any] = {
            "depth": sum(depth_by_q.values()),
            "depth_by_queue": depth_by_q,
            "inflight": self.broker.inflight(),
            "consumers": sum(consumers.values()),
            "consumers_by_queue": consumers,
            "managed_workers": self.workers(),
            "pools": len(self.pools),
            "utilization": 0.0,
            "members": None,
            "migrating": list(stats.get("migrating") or ()),
        }
        if self.engine_stats is not None:
            try:
                obs["utilization"] = float(
                    (self.engine_stats() or {}).get("utilization", 0.0))
            except Exception:
                pass  # a dead engine must not kill the scaling loop
        if self.membership_path is not None:
            from repro_torch.core.hashring import read_membership
            m = read_membership(self.membership_path)
            if m is not None:
                obs["members"] = len(m.members)
                obs["ring_version"] = m.version
        return obs

    # -- planning ------------------------------------------------------------
    def _cooled_down(self, now: float) -> bool:
        return (self._last_action_at is None
                or now - self._last_action_at >= self.policy.cooldown_s)

    def plan(self) -> ScalePlan:
        """Evaluate the policy against one observation (no side effects
        beyond the idle-window tracker)."""
        p = self.policy
        now = self._clock()
        obs = self.observe()
        plan = ScalePlan(at=now, observed=obs)

        depth, inflight = obs["depth"], obs["inflight"]
        util = obs["utilization"]
        busy = depth > 0 or inflight > 0
        if busy:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = now
        obs["idle_s"] = 0.0 if self._idle_since is None \
            else round(now - self._idle_since, 3)

        # drain capacity: managed workers, or live external consumers
        # when we manage none yet (don't double-provision a federation
        # that already has workers attached elsewhere)
        managed = self.workers()
        capacity = max(1, managed if managed > 0 else obs["consumers"])
        per_worker = depth / capacity
        obs["backlog_per_worker"] = round(per_worker, 3)

        want_up = (per_worker > p.up_backlog_per_worker
                   or (depth > 0 and util >= p.engine_busy_high))
        if want_up and managed < p.max_workers and self._cooled_down(now):
            n = min(p.pool_size, p.max_workers - managed)
            if n > 0:
                why = (f"backlog/worker {per_worker:.1f} > "
                       f"{p.up_backlog_per_worker:g}"
                       if per_worker > p.up_backlog_per_worker
                       else f"engine busy {util:.2f} >= "
                            f"{p.engine_busy_high:g}")
                plan.actions.append(
                    ScaleAction("workers_up", n=n, reason=why))

        idle_long = (self._idle_since is not None
                     and now - self._idle_since >= p.down_idle_s)
        if (not plan.actions and idle_long and self.pools
                and managed > p.min_workers
                and util < p.engine_busy_high
                and self._cooled_down(now)):
            n = min(self._pool_sizes[-1], managed - p.min_workers)
            if n > 0:
                plan.actions.append(ScaleAction(
                    "workers_down", n=n,
                    reason=f"idle {now - self._idle_since:.1f}s >= "
                           f"{p.down_idle_s:g}s"))

        # shard-level: advisory only — starting/stopping broker servers
        # is a deployment action the operator takes (broker-serve --join)
        members = obs.get("members")
        if depth > p.shard_up_depth:
            plan.recommendations.append(ScaleAction(
                "shard_join", n=1,
                reason=f"total backlog {depth} > {p.shard_up_depth}"))
        elif (members is not None and members > 1
              and depth <= p.shard_down_depth and inflight == 0):
            plan.recommendations.append(ScaleAction(
                "shard_leave", n=1,
                reason=f"backlog {depth} <= {p.shard_down_depth} "
                       f"across {members} members"))
        return plan

    # -- application ---------------------------------------------------------
    def apply(self, plan: ScalePlan) -> Dict[str, Any]:
        """Execute the plan's worker actions (needs ``pool_factory``) and
        sweep heartbeat-expired members from the membership file."""
        applied: List[ScaleAction] = []
        for a in plan.actions:
            if a.kind == "workers_up":
                if self.pool_factory is None:
                    continue
                pool = self.pool_factory(a.n)
                self.pools.append(pool)
                self._pool_sizes.append(a.n)
            elif a.kind == "workers_down":
                if not self.pools:
                    continue
                pool = self.pools.pop()
                self._pool_sizes.pop()
                pool.shutdown()
            else:
                continue
            self._last_action_at = plan.at
            applied.append(a)

        evicted: List[str] = []
        if self.membership_path is not None:
            from repro_torch.core.hashring import sweep_membership
            try:
                _, evicted = sweep_membership(self.membership_path,
                                              self.policy.membership_ttl)
            except OSError:
                pass  # registry briefly unavailable; next tick retries
        return {"applied": applied, "evicted": evicted}

    def step(self) -> ScalePlan:
        """One loop iteration: plan, apply, return the (annotated) plan."""
        plan = self.plan()
        result = self.apply(plan)
        plan.observed["applied"] = [a.to_doc() for a in result["applied"]]
        if result["evicted"]:
            plan.observed["evicted_members"] = result["evicted"]
        return plan

    def shutdown(self) -> None:
        """Retire every managed pool (reverse creation order)."""
        while self.pools:
            self.pools.pop().shutdown()
            self._pool_sizes.pop()
