"""The Merlin producer-consumer runtime, DAG edition.

``MerlinRuntime.run(spec, samples)`` is ``merlin run``: it compiles the
spec into a :class:`~repro_torch.core.dag.TaskDag` (arbitrary fan-in/fan-out,
chain-fused sample-parallel nodes), persists the study + initial DAG
state, and enqueues ONE root task per source node instance — the
near-non-blocking producer of Sec. 2.3.  Workers (core/worker.py) expand
the hierarchy and execute sample bundles through pluggable
:mod:`~repro_torch.core.handlers`; and — Celery-chord-like, fully
decentralized — whichever worker completes a node instance's LAST bundle
walks that instance's out-edges and unlocks exactly the children whose
fan-in is now satisfied.  All coordination lives in crash-safe file
counters / once-markers (flock / O_EXCL), so workers in different
processes / "batch allocations" agree without a central orchestrator;
the persisted ``<study>.dag.json`` (via :mod:`~repro_torch.core.jsonstore`) is
the human/status-tool view of the same progress, and
``attach(study, resume=True)`` re-arms an interrupted study mid-graph.

Dynamic data flow between nodes rides on *named sample sets*: a step may
call ``ctx.publish_samples("posterior", arr)`` and a downstream step
with ``sample_set: posterior`` iterates exactly that array — how the
COVID cascade's phase 2 became an ordinary graph edge instead of a
nested ``runtime.run()`` call from inside a worker.
"""
from __future__ import annotations

import fcntl
import json
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import hierarchy as H
from repro_torch.core import jsonstore
from repro_torch.core.dag import DagNode, TaskDag, compile_dag
from repro_torch.core.handlers import ExecutionHandler, default_handlers
from repro_torch.core.queue import (PRIORITY_GEN, PRIORITY_REAL, BrokerError,
                              InMemoryBroker, Lease, Task, new_task)
from repro_torch.core.resilience import BackoffPolicy
from repro_torch.core.spec import Step, StudySpec, expand_parameters, substitute


# ---------------------------------------------------------------------------
# crash-safe counters / once-markers / journal
# ---------------------------------------------------------------------------

class FileCounter:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "_") + ".cnt")

    def incr(self, key: str, by: int = 1) -> int:
        path = self._path(key)
        fd = os.open(path, os.O_RDWR | os.O_CREAT)
        with os.fdopen(fd, "r+") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            raw = f.read().strip()
            val = (int(raw) if raw else 0) + by
            f.seek(0)
            f.truncate()
            f.write(str(val))
            f.flush()
            return val

    def get(self, key: str) -> int:
        try:
            with open(self._path(key)) as f:
                raw = f.read().strip()
                return int(raw) if raw else 0
        except FileNotFoundError:
            return 0

    def once(self, key: str) -> bool:
        """True exactly once per key across all processes (O_EXCL)."""
        path = os.path.join(self.root, key.replace("/", "_") + ".once")
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            return True
        except FileExistsError:
            return False

    def once_exists(self, key: str) -> bool:
        return os.path.exists(
            os.path.join(self.root, key.replace("/", "_") + ".once"))


class Journal:
    """Append-only jsonl event log (provenance + restart/crawl substrate)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._lock = threading.Lock()

    def append(self, event: Dict[str, Any]) -> None:
        event = {"t": time.time(), **event}
        # leading newline isolates this record from any torn write a crashed
        # worker left behind; replay skips the blank lines it creates
        line = "\n" + json.dumps(event) + "\n"
        with self._lock, open(self.path, "a") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            f.write(line)

    def replay(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        pass  # torn write from a crashed worker
        return out

    def done_bundles(self, study: str) -> set:
        done = set()
        for ev in self.replay():
            if ev.get("ev") == "bundle_done" and ev.get("study") == study:
                done.add((ev["stage"], ev["combo"], ev["lo"], ev["hi"]))
        return done


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

class Context:
    """Execution context handed to fn-steps.

    ``sub_ranges`` is the coalescing contract: when a worker fuses several
    contiguous leaf tasks into one execution (``execute_real_many``), the
    step sees ONE context spanning the union [lo, hi) plus the original
    per-task [slo, shi) spans.  Steps that write per-range artifacts (the
    ensemble executor's bundle files) iterate ``sub_ranges`` so the on-disk
    layout is identical to per-task execution; steps that ignore it simply
    process the whole block at once.

    ``publish_samples`` feeds downstream DAG nodes: the array becomes a
    named sample set scoped to this context's parameter combo, and any
    node with a matching ``sample_set`` iterates it.
    """

    def __init__(self, runtime: "MerlinRuntime", study: str, combo: Dict,
                 samples: Optional[np.ndarray], lo: int, hi: int,
                 workspace: str, variables: Dict,
                 sub_ranges: Optional[Sequence[tuple]] = None,
                 deferred: bool = False):
        self.runtime = runtime
        self.study = study
        self.combo = combo
        self.samples = samples
        self.lo, self.hi = lo, hi
        self.workspace = workspace
        self.variables = variables
        self.sub_ranges = list(sub_ranges) if sub_ranges else [(lo, hi)]
        self._deferred: Optional[list] = [] if deferred else None

    @property
    def sample_block(self) -> Optional[np.ndarray]:
        return None if self.samples is None else self.samples[self.lo:self.hi]

    @property
    def deferrable(self) -> bool:
        """True under deferred execution: completion work registered with
        ``defer`` runs on the engine's writer thread, overlapping the next
        batch's dispatch, instead of blocking the step."""
        return self._deferred is not None

    def defer(self, fn: Callable[[], None]) -> None:
        """Register completion work (host sync + artifact writes).  Under
        deferred execution it runs later, before this context's tasks get
        their once-markers; otherwise it runs immediately — steps may call
        this unconditionally."""
        if self._deferred is None:
            fn()
        else:
            self._deferred.append(fn)

    def run_deferred(self) -> None:
        """Run (and clear) the registered completion work, in order."""
        if self._deferred:
            fns, self._deferred = self._deferred, []
            for fn in fns:
                fn()

    def publish_samples(self, name: str, arr) -> None:
        """Publish ``arr`` as sample set ``name`` scoped to this combo, for
        downstream nodes declaring ``sample_set: name``."""
        self.runtime.publish_samples(self.study, name, arr, scope=self.combo)


class MerlinRuntime:
    def __init__(self, broker=None, workspace: str = "/tmp/merlin",
                 fns: Optional[Dict[str, Callable]] = None,
                 hierarchy: H.HierarchyCfg = H.HierarchyCfg(),
                 real_queue: str = "real", gen_queue: str = "gen",
                 handlers: Optional[Dict[str, ExecutionHandler]] = None):
        # broker may be a Broker instance or a URL: "tcp://host:port"
        # connects to a remote BrokerServer (no shared filesystem for the
        # queue — the paper's cross-allocation RabbitMQ model), "file://dir"
        # a shared-directory FileBroker, "mem://" a private InMemoryBroker,
        # "shard://h1:p1,h2:p2" (or a list of tcp:// endpoints) a
        # ShardedBroker federating several BrokerServers by queue name.
        if isinstance(broker, (str, list, tuple)):
            from repro_torch.core.netbroker import make_broker
            broker = make_broker(broker)
        self.broker = broker if broker is not None else InMemoryBroker()
        self.workspace = workspace
        os.makedirs(workspace, exist_ok=True)
        self.fns = dict(fns or {})
        self.hcfg = hierarchy
        # Sec. 2.2 routing: simulation (real) tasks and task-generation
        # tasks live on separate named queues so workers can subscribe to
        # either stream; priority still drains real before gen globally.
        # A node's spec-level `queue:` annotation overrides real_queue for
        # that node's leaf tasks.
        self.real_queue = real_queue
        self.gen_queue = gen_queue
        self.counters = FileCounter(os.path.join(workspace, "_counters"))
        self.journal = Journal(os.path.join(workspace, "_journal.jsonl"))
        self.handlers: Dict[str, ExecutionHandler] = \
            dict(handlers) if handlers is not None else default_handlers()
        # one micro-batching ExecutionEngine per runtime (lazily created):
        # every WorkerPool attached to this runtime feeds the same
        # scheduler, so fused launches span pools as well as workers
        self._engine = None
        self._engine_lock = threading.Lock()
        self._specs: Dict[str, StudySpec] = {}
        self._dags: Dict[str, TaskDag] = {}
        self._samples: Dict[str, Optional[np.ndarray]] = {}  # "default" set
        self._meta_n: Dict[str, int] = {}
        self._pub_cache: Dict[str, np.ndarray] = {}  # published .npy files

    def register(self, name: str, fn: Callable) -> None:
        self.fns[name] = fn

    def register_handler(self, handler: ExecutionHandler) -> None:
        """Install (or replace) an execution handler under ``handler.name``;
        specs select it per step via ``run: {handler: <name>}``."""
        self.handlers[handler.name] = handler

    def shared_engine(self, **cfg):
        """This runtime's shared :class:`~repro_torch.core.engine.ExecutionEngine`
        (created on first use, re-created after the last pool closed it).

        Returns the engine with one reference attached — callers pair this
        with ``engine.detach()`` (WorkerPool does both automatically).
        ``cfg`` (``max_batch``, ``max_wait_ms``) only applies when this
        call creates the engine; later callers share the first
        configuration.
        """
        from repro_torch.core.engine import EngineClosed, ExecutionEngine
        with self._engine_lock:
            while True:
                if self._engine is None or self._engine.closed:
                    self._engine = ExecutionEngine(self, **cfg)
                try:
                    return self._engine.attach()
                except EngineClosed:
                    # lost a race with the last pool's detach-close:
                    # build a fresh engine on the next spin
                    self._engine = None

    # -- study registration --------------------------------------------------
    def register_study(self, spec: StudySpec,
                       study_id: Optional[str] = None,
                       samples: Optional[np.ndarray] = None) -> str:
        """Compile ``spec`` and make the study executable by THIS runtime
        (fills the dag/spec/sample tables workers consult).  ``run()`` and
        ``attach()`` both route through here; tests and benchmarks that
        enqueue hand-built tasks use it directly instead of poking at
        private tables."""
        dag = compile_dag(spec)
        for node in dag.nodes:  # fail fast, not at worker-execute time
            self._handler_for(node)
        study = study_id or f"{spec.name}-{uuid.uuid4().hex[:8]}"
        self._specs[study] = spec
        self._dags[study] = dag
        self._samples[study] = samples
        self._meta_n[study] = (len(samples) if samples is not None
                               else self.hcfg.bundle)
        return study

    def dag(self, study: str) -> TaskDag:
        return self._dags[study]

    # -- producer ("merlin run") -------------------------------------------
    def run(self, spec: StudySpec, samples: Optional[np.ndarray] = None,
            study_id: Optional[str] = None) -> str:
        study = self.register_study(spec, study_id, samples)
        dag = self._dags[study]
        n = self._meta_n[study]
        # persist study metadata so cross-process workers can reconstruct it
        meta = {"study": study, "n_samples": n,
                "spec": _spec_to_dict(spec)}
        mpath = os.path.join(self.workspace, f"{study}.study.json")
        # samples first, then meta, both via atomic rename: attach() treats
        # the meta file as the commit point, so a crash mid-persist must
        # never leave valid meta next to a missing/torn samples file
        if samples is not None:
            spath = os.path.join(self.workspace, f"{study}.samples.npy")
            with open(spath + ".tmp", "wb") as f:
                np.save(f, samples)
            os.rename(spath + ".tmp", spath)
        with open(mpath + ".tmp", "w") as f:
            json.dump(meta, f)
        os.rename(mpath + ".tmp", mpath)
        self._state_init(study, dag)
        self.journal.append({"ev": "study_start", "study": study, "n": n})
        for nidx, iidx in dag.roots():
            # claim the enqueue marker so a later (buggy or racing) unlock
            # cannot double-enqueue a root
            self.counters.once(f"{study}/s{nidx}/c{iidx}/enqueue")
            self._enqueue_node(study, nidx, iidx)
        return study

    def _put_resilient(self, task: Task, attempts: int = 8) -> None:
        """Enqueue with bounded backoff retry.  ``_enqueue_node`` runs
        behind an already-consumed once(enqueue) marker — a transient
        broker error here is the study's ONLY chance to enqueue that
        instance, so it must ride out short outages instead of wedging
        the graph."""
        backoff = BackoffPolicy(base=0.05, cap=1.0)
        for attempt in range(attempts):
            try:
                self.broker.put(task)
                return
            except BrokerError:
                if attempt == attempts - 1:
                    raise
                time.sleep(backoff.delay(attempt))

    def _enqueue_node(self, study: str, nidx: int, iidx: int) -> None:
        """Put the root task for one node instance on the broker."""
        if self.study_halted(study):
            return  # halted studies grow no new work
        dag = self._dags[study]
        node = dag.nodes[nidx]
        extra = {"study": study, "stage": nidx, "combo": iidx,
                 "real_queue": node.queue or self.real_queue,
                 "gen_queue": self.gen_queue}
        if node.kind == "single":
            extra["n_samples"] = 1
            self._put_resilient(new_task("real",
                                         {**extra, "samples": [0, 1],
                                          "fanout": self.hcfg.max_fanout,
                                          "bundle": 1},
                                         priority=PRIORITY_REAL,
                                         queue=extra["real_queue"]))
        else:
            _, n = self._resolve_samples(study, node, node.instances[iidx])
            extra["n_samples"] = n
            self._put_resilient(H.root_task(study, str(nidx), n, self.hcfg,
                                            extra=extra))
        self._state_set(study, nidx, iidx, "running")
        self.journal.append({"ev": "stage_start", "study": study,
                             "stage": nidx, "combo": iidx})

    def attach(self, study: str, resume: bool = False) -> str:
        """Load a study persisted by another runtime instance's ``run()``.

        Reconstructs the spec/dag/samples from the workspace's
        ``<study>.study.json`` + ``<study>.samples.npy`` so workers in a
        fresh process (a new "batch allocation", or a restart after a
        crash) can execute and advance a study they did not start.  Node
        counters and once-markers live on disk, so progress made before
        the crash is preserved mid-graph.  ``resume=True`` additionally
        re-enqueues every ready-but-incomplete node instance (see
        :meth:`resume`) so the study completes even if the queued tasks
        died with the previous broker/process.
        """
        mpath = os.path.join(self.workspace, f"{study}.study.json")
        with open(mpath) as f:
            meta = json.load(f)
        spec = _spec_from_dict(meta["spec"])
        spath = os.path.join(self.workspace, f"{study}.samples.npy")
        samples = np.load(spath) if os.path.exists(spath) else None
        self.register_study(spec, study_id=study, samples=samples)
        self._meta_n[study] = int(meta.get("n_samples",
                                           self._meta_n[study]))
        if resume:
            self.resume(study)
        return study

    def resume(self, study: str) -> List[Tuple[int, int]]:
        """Re-enqueue every node instance that is ready (all parents done)
        but not itself complete.  Safe against duplicates: execution is
        idempotent (done-markers), completed bundles of a half-finished
        instance no-op, and the advance/enqueue once-markers keep the
        unlock accounting exactly-once.  Returns the re-armed (node,
        instance) pairs."""
        dag = self._dags[study]
        requeued: List[Tuple[int, int]] = []
        for nidx, iidx in dag.all_instances():
            if self.counters.once_exists(f"{study}/s{nidx}/c{iidx}/advance"):
                continue  # already complete
            parents = dag.instance_parents(nidx, iidx)
            if not all(self.counters.once_exists(f"{study}/s{p}/c{q}/advance")
                       for p, q in parents):
                continue  # not unlocked yet: its parent's completion will do it
            self.counters.once(f"{study}/s{nidx}/c{iidx}/enqueue")
            self._enqueue_node(study, nidx, iidx)
            requeued.append((nidx, iidx))
        self.journal.append({"ev": "study_resume", "study": study,
                             "requeued": len(requeued)})
        return requeued

    # -- persisted DAG state (the status view; counters are the truth) ------
    def _state_path(self, study: str) -> str:
        return os.path.join(self.workspace, f"{study}.dag.json")

    def _state_init(self, study: str, dag: TaskDag) -> None:
        doc = dag.to_doc()
        doc["state"] = {f"s{n}/c{i}": {"status": "pending"}
                        for n, i in dag.all_instances()}
        jsonstore.save_json(self._state_path(study), doc)

    def _state_set(self, study: str, nidx: int, iidx: int, status: str,
                   epoch: Optional[int] = None) -> None:
        def upd(doc: Dict[str, Any]) -> None:
            ent = doc.setdefault("state", {}).setdefault(
                f"s{nidx}/c{iidx}", {})
            # never regress a terminal status: a resume's "running" update
            # racing a completer's "done" must lose
            if ent.get("status") == "done" and status != "done":
                return
            ent["status"] = status
            if epoch is not None:
                ent["epoch"] = epoch
        jsonstore.update_json(self._state_path(study), upd)

    def dag_state(self, study: str) -> Dict[str, Any]:
        """The persisted per-node status/epoch view (for status tooling)."""
        return jsonstore.load_json(self._state_path(study), default={})

    def note_failure(self, task: Task) -> None:
        """Mark a node instance failed in the persisted state (called when
        the retry policy gives a task up as poison).  Advisory: the
        counters still hold, and a later successful retry/crawl flips the
        instance back to done."""
        p = task.payload
        try:
            study, nidx, iidx = p["study"], p["stage"], p["combo"]
        except (KeyError, TypeError):
            return
        if study in self._dags:
            self._state_set(study, nidx, iidx, "failed")

    # -- per-step failure policy (ISSUE 7 tentpole) -------------------------
    def node_for(self, task: Task) -> Optional[DagNode]:
        """The DAG node a task belongs to, or None when this runtime does
        not know the study (a foreign task: fall back to worker defaults)."""
        try:
            p = task.payload
            return self._dags[p["study"]].nodes[p["stage"]]
        except (KeyError, IndexError, TypeError):
            return None

    def failure_policy(self, task: Task) -> Optional[Tuple[str, int]]:
        """``(on_failure, max_retries)`` for a task's node — the per-step
        policy the worker enforces at retry exhaustion.  None for tasks of
        unknown studies (the worker's own RetryPolicy applies)."""
        node = self.node_for(task)
        if node is None:
            return None
        return node.on_failure, node.max_retries

    def complete_skipped(self, task: Task) -> None:
        """``on_failure: skip``: record the bundle as complete WITHOUT
        executing it, so the node's counter advances and children unlock.
        The once-marker keeps this idempotent against redelivered copies
        racing a real completion."""
        if self.counters.once(self._done_key(task)):
            p = task.payload
            self.journal.append({"ev": "task_skipped", "study": p["study"],
                                 "stage": p["stage"], "combo": p["combo"],
                                 "lo": p["samples"][0],
                                 "hi": p["samples"][1]})
            self._bundle_done(task)

    def halt_study(self, study: str, reason: str = "") -> bool:
        """``on_failure: halt_study``: stop the whole study.  The halt is a
        crash-safe once-marker every process sees; workers drain the
        study's remaining tasks by acking them unexecuted, and no new node
        instance is enqueued or unlocked.  Returns True for the caller
        that actually performed the halt."""
        if not self.counters.once(f"{study}/halt"):
            return False
        self.journal.append({"ev": "study_halt", "study": study,
                             "reason": reason})

        def upd(doc: Dict[str, Any]) -> None:
            for ent in doc.get("state", {}).values():
                if ent.get("status") != "done":
                    ent["status"] = "halted"
        jsonstore.update_json(self._state_path(study), upd)
        return True

    def study_halted(self, study: str) -> bool:
        return self.counters.once_exists(f"{study}/halt")

    def task_halted(self, task: Task) -> bool:
        """True when this task belongs to a halted study (workers ack-drop
        such tasks instead of executing them — the passive drain)."""
        try:
            study = task.payload["study"]
        except (KeyError, TypeError):
            return False
        return isinstance(study, str) and self.study_halted(study)

    # -- named sample sets ---------------------------------------------------
    def publish_samples(self, study: str, name: str, arr,
                        scope: Optional[Dict[str, Any]] = None) -> None:
        """Persist ``arr`` as sample set ``name`` scoped to parameter values
        ``scope``; downstream nodes with ``sample_set: name`` whose combo
        matches the scope iterate it.  Crash-safe: the .npy commits via
        atomic rename before the locked index update, and re-publishing
        the same scope (a retried producer) replaces the entry."""
        arr = np.asarray(arr)
        scope = dict(scope or {})
        fname = f"{study}.samples.{name}.{uuid.uuid4().hex[:8]}.npy"
        path = os.path.join(self.workspace, fname)
        with open(path + ".tmp", "wb") as f:
            np.save(f, arr)
        os.rename(path + ".tmp", path)
        idx_path = os.path.join(self.workspace,
                                f"{study}.samples_index.json")

        def upd(doc: Dict[str, Any]) -> None:
            ents = doc.setdefault(name, [])
            ents[:] = [e for e in ents if e.get("combo") != scope]
            ents.append({"combo": scope, "n": int(len(arr)), "file": fname})
        jsonstore.update_json(idx_path, upd)
        self.journal.append({"ev": "samples_published", "study": study,
                             "set": name, "n": int(len(arr)),
                             "scope": scope})

    def _resolve_samples(self, study: str, node: DagNode,
                         inst: Dict[str, Any]):
        """The (array, count) a node instance iterates.  ``default`` is the
        study-level array passed to ``run()``; anything else must have
        been published (by an upstream step, before it completed) with a
        scope matching this instance — most-specific scope wins."""
        if node.sample_set == "default":
            arr = self._samples.get(study)
            n = len(arr) if arr is not None \
                else self._meta_n.get(study, self.hcfg.bundle)
            return arr, n
        idx_path = os.path.join(self.workspace,
                                f"{study}.samples_index.json")
        ents = jsonstore.load_json(idx_path, default={}).get(
            node.sample_set, [])
        best = None
        for e in ents:
            sc = e.get("combo", {})
            if all(k in inst and inst[k] == v for k, v in sc.items()):
                if best is None or len(sc) > len(best.get("combo", {})):
                    best = e
        if best is None:
            raise RuntimeError(
                f"study {study}: no published sample set "
                f"'{node.sample_set}' matches node '{node.name}' instance "
                f"{inst!r} — the producing step must call "
                f"ctx.publish_samples(...) before it completes")
        fname = best["file"]
        if fname not in self._pub_cache:
            self._pub_cache[fname] = np.load(
                os.path.join(self.workspace, fname))
        return self._pub_cache[fname], int(best["n"])

    # -- node bookkeeping (called by workers at bundle completion) ----------
    def _bundle_done(self, task: Task) -> None:
        p = task.payload
        study, nidx, iidx = p["study"], p["stage"], p["combo"]
        node = self._dags[study].nodes[nidx]
        if node.kind == "single":
            expected = 1
        else:
            # bundle size from the task payload, not this process's hcfg: a
            # runtime that attach()ed with a different config must still
            # agree with the producer on how many bundles complete a node
            n = p["n_samples"]
            expected = -(-n // p.get("bundle", self.hcfg.bundle))
        key = f"{study}/s{nidx}/c{iidx}"
        done = self.counters.incr(key)
        self.journal.append({"ev": "bundle_done", "study": study,
                             "stage": nidx, "combo": iidx,
                             "lo": p["samples"][0], "hi": p["samples"][1]})
        if done >= expected and self.counters.once(key + "/advance"):
            self.journal.append({"ev": "stage_done", "study": study,
                                 "stage": nidx, "combo": iidx})
            # completion epoch: a per-study monotonic clock shared by every
            # process via the flock'd counter — orders node completions for
            # the persisted state and the resume audit
            epoch = self.counters.incr(f"{study}/epoch")
            self._state_set(study, nidx, iidx, "done", epoch=epoch)
            self._unlock_children(study, nidx, iidx)
            if self.study_done(study) and self.counters.once(f"{study}/done"):
                self.journal.append({"ev": "study_done", "study": study})

    def _unlock_children(self, study: str, nidx: int, iidx: int) -> None:
        """The generalized chord: walk this instance's out-edges; each child
        instance counts satisfied parents in a crash-safe counter and the
        worker that supplies the LAST one enqueues it (exactly once, via
        the enqueue marker)."""
        if self.study_halted(study):
            return
        dag = self._dags[study]
        for m, j in dag.instance_children(nidx, iidx):
            need = dag.indegree(m, j)
            got = self.counters.incr(f"{study}/unlock/s{m}/c{j}")
            if got >= need and self.counters.once(f"{study}/s{m}/c{j}/enqueue"):
                self._enqueue_node(study, m, j)

    # -- execution of a real task -------------------------------------------
    def _node_fusable(self, node: DagNode) -> bool:
        """THE fusion predicate — the single definition both the worker's
        engine-routing decision (``coalescable``) and the grouping in
        ``execute_real_many`` consult, so they can never disagree about
        what fuses: sample-parallel nodes whose handler runs in-process."""
        h = self.handlers.get(node.handler)
        return node.kind == "parallel" and h is not None and h.inprocess

    def _handler_for(self, node: DagNode) -> ExecutionHandler:
        try:
            return self.handlers[node.handler]
        except KeyError:
            raise RuntimeError(
                f"node '{node.name}' wants handler '{node.handler}' but only "
                f"{sorted(self.handlers)} are registered "
                f"(runtime.register_handler adds more)")

    def coalescable(self, task: Task) -> bool:
        """True when this real task can profit from fused execution: its
        node is sample-parallel with an in-process handler (the only thing
        ``execute_real_many`` fuses).  Subprocess/scheduler and funnel-node
        tasks — and tasks for studies this runtime does not know — return
        False: workers run those in their own threads, where N workers
        really do mean N concurrent subprocesses, instead of serializing
        them behind the engine's single dispatcher."""
        try:
            p = task.payload
            node = self._dags[p["study"]].nodes[p["stage"]]
        except (KeyError, IndexError, TypeError):
            return False
        return self._node_fusable(node)

    def affinity_key(self, task: Task):
        """The engine's coalescing-bucket key: ``(study, simulator)``.

        Tasks only micro-batch with key-mates, so one fused dispatch never
        interleaves two studies' (or two simulators') bundles — a mixed
        buffer would shred ``execute_real_many``'s contiguity grouping
        into per-study fragments of a half-empty batch.  The simulator
        identity is the node's step fn/cmd tuple; tasks for studies this
        runtime does not know share the ``None`` bucket (they are not
        coalescable anyway)."""
        try:
            p = task.payload
            study = p["study"]
            node = self._dags[study].nodes[p["stage"]]
        except (KeyError, IndexError, TypeError):
            return None
        return (study, tuple(s.fn or s.cmd for s in node.steps))

    @staticmethod
    def _done_key(task: Task) -> str:
        p = task.payload
        lo, hi = p["samples"]
        return f"{p['study']}/exec/s{p['stage']}/c{p['combo']}/{lo}_{hi}"

    def execute_real(self, task: Task) -> None:
        p = task.payload
        study, nidx, iidx = p["study"], p["stage"], p["combo"]
        lo, hi = p["samples"]
        done_key = self._done_key(task)
        # idempotency: if a previous attempt *completed*, redelivered or
        # speculatively-duplicated copies no-op.  Failed attempts leave no
        # marker, so retries re-execute.
        if self.counters.once_exists(done_key):
            return
        spec = self._specs[study]
        node = self._dags[study].nodes[nidx]
        inst = node.instances[iidx]
        samples, _ = self._resolve_samples(study, node, inst)
        wdir = os.path.join(self.workspace, study, f"s{nidx}",
                            f"c{iidx}", f"b{lo:09d}_{hi:09d}")
        os.makedirs(wdir, exist_ok=True)
        ctx = Context(self, study, inst, samples, lo, hi, wdir,
                      spec.variables)
        handler = self._handler_for(node)
        for step in node.steps:
            handler.execute(self, step, ctx)
        # first completer wins; concurrent duplicates are safe (atomic writes)
        if self.counters.once(done_key):
            self._bundle_done(task)

    # -- coalesced execution of a lease batch --------------------------------
    def execute_real_many(self, tasks: Sequence[Task]) -> None:
        """Execute a batch of real tasks, fusing contiguous sample ranges.

        Coalescing policy: tasks from the same (study, node, instance)
        whose [lo, hi) ranges are contiguous — the common case when one
        ``get_many`` drains a generator's leaf burst — execute as ONE step
        invocation over the union range (one fused vmap launch for ensemble
        steps) with ``ctx.sub_ranges`` carrying the original spans.  Only
        sample-parallel nodes with in-process handlers coalesce; subprocess
        / scheduler steps and funnel nodes keep per-task execution (their
        workspace layout is per-task).  Idempotency is unchanged: every
        original task still gets its own once-marker and ``_bundle_done``
        accounting, and already-done tasks are skipped before grouping.
        If a fused execution fails, the whole group falls back to per-task
        ``execute_real`` so one poison task cannot take down its
        batch-mates' progress or retry accounting.
        """
        self._execute_many(tasks, deferred=False)

    def execute_real_many_deferred(
            self, tasks: Sequence[Task]) -> Callable[[], None]:
        """Pipelined variant of :meth:`execute_real_many` for the engine's
        writer thread: device compute for every fused run is dispatched
        *now* (asynchronously), while the host-side completion — the
        ``block_until_ready`` sync, bundle writes, and once-markers — is
        packaged into the returned ``finalize()`` callable.  The engine
        runs finalize on its single writer thread, so the dispatch of
        batch N+1 overlaps the write of batch N.  Exceptions inside
        finalize propagate; the engine then re-runs the batch per-task
        (completed runs no-op on their once-markers)."""
        return self._execute_many(tasks, deferred=True)

    def _execute_many(self, tasks: Sequence[Task],
                      deferred: bool) -> Optional[Callable[[], None]]:
        groups: Dict[tuple, List[Task]] = {}
        singles: List[Task] = []
        for t in tasks:
            if self.counters.once_exists(self._done_key(t)):
                continue  # a previous attempt completed: no-op, no re-count
            p = t.payload
            node = self._dags[p["study"]].nodes[p["stage"]]
            if self._node_fusable(node):
                groups.setdefault((p["study"], p["stage"], p["combo"]),
                                  []).append(t)
            else:
                singles.append(t)
        for t in singles:
            self.execute_real(t)
        if deferred:
            fins = []
            for run in self._contiguous_runs(groups):
                try:
                    fins.append(self._execute_coalesced(run, deferred=True))
                except Exception:
                    # poison run: its compute failure must not discard the
                    # sibling runs already dispatched (their once-markers
                    # live in finalize) — package this run's per-task
                    # retry into the finalize stage instead, mirroring the
                    # sync path's per-run isolation
                    fins.append(lambda run=run: [self.execute_real(t)
                                                 for t in run])

            def finalize() -> None:
                for fin in fins:
                    fin()
            return finalize
        for run in self._contiguous_runs(groups):
            if len(run) == 1:
                self.execute_real(run[0])
                continue
            try:
                self._execute_coalesced(run)
            except Exception:
                for t in run:  # isolate the failure: per-task retry semantics
                    self.execute_real(t)
        return None

    @staticmethod
    def _contiguous_runs(groups: Dict[tuple, List[Task]]) -> List[List[Task]]:
        runs: List[List[Task]] = []
        for ts in groups.values():
            ts.sort(key=lambda t: t.payload["samples"][0])
            cur = [ts[0]]
            for t in ts[1:]:
                if t.payload["samples"][0] == cur[-1].payload["samples"][1]:
                    cur.append(t)
                else:
                    runs.append(cur)
                    cur = [t]
            runs.append(cur)
        return runs

    def _execute_coalesced(self, run: List[Task],
                           deferred: bool = False
                           ) -> Optional[Callable[[], None]]:
        """One fused execution covering a contiguous run of leaf tasks.

        With ``deferred=True`` the steps run now (device compute
        dispatches asynchronously; steps park their host sync + artifact
        writes on ``ctx.defer``) and the returned closure performs the
        deferred completion work *then* sets the once-markers — durable
        write strictly before the marker that suppresses re-execution."""
        p = run[0].payload
        study, nidx, iidx = p["study"], p["stage"], p["combo"]
        lo = p["samples"][0]
        hi = run[-1].payload["samples"][1]
        spec = self._specs[study]
        node = self._dags[study].nodes[nidx]
        inst = node.instances[iidx]
        samples, _ = self._resolve_samples(study, node, inst)
        wdir = os.path.join(self.workspace, study, f"s{nidx}",
                            f"c{iidx}", f"b{lo:09d}_{hi:09d}")
        os.makedirs(wdir, exist_ok=True)
        ctx = Context(self, study, inst, samples, lo, hi, wdir,
                      spec.variables,
                      sub_ranges=[tuple(t.payload["samples"]) for t in run],
                      deferred=deferred)
        handler = self._handler_for(node)
        for step in node.steps:
            handler.execute(self, step, ctx)

        def finalize() -> None:
            ctx.run_deferred()
            for t in run:  # per-sub-bundle markers + node accounting
                if self.counters.once(self._done_key(t)):
                    self._bundle_done(t)
        if deferred:
            return finalize
        finalize()
        return None

    # -- completion ----------------------------------------------------------
    def study_done(self, study: str) -> bool:
        dag = self._dags[study]
        return all(
            self.counters.once_exists(f"{study}/s{n}/c{i}/advance")
            for n, i in dag.all_instances())

    def wait(self, study: str, timeout: float = 120.0, poll: float = 0.02) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.study_done(study):
                return True
            if self.study_halted(study):
                return False  # halt is terminal: don't poll out the timeout
            time.sleep(poll)
        return False


def _spec_to_dict(spec: StudySpec) -> Dict:
    import dataclasses as dc
    return {"name": spec.name, "parameters": spec.parameters,
            "variables": spec.variables,
            "steps": [dc.asdict(s) for s in spec.steps]}


def _spec_from_dict(d: Dict) -> StudySpec:
    steps = []
    for s in d["steps"]:
        kw = dict(s)
        kw["depends"] = tuple(kw.get("depends", ()))
        if kw.get("params") is not None:
            kw["params"] = tuple(kw["params"])
        steps.append(Step(**kw))
    return StudySpec(name=d["name"], steps=steps,
                     parameters=d.get("parameters", {}),
                     variables=d.get("variables", {}))
