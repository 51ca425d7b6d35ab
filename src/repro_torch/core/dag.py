"""Task-graph IR — what a :class:`~repro_torch.core.spec.StudySpec` compiles to.

The spec surface stays Maestro-flavored YAML/dataclasses; *this* module is
the explicit graph the runtime executes.  ``compile_dag`` turns the
step list into :class:`DagNode` s with arbitrary fan-in/fan-out:

* **Chain fusion** — maximal linear runs of sample-parallel steps with a
  single plain edge between them and identical routing (queue, handler,
  sample set, params) collapse into ONE node.  A fused node executes all
  its steps back-to-back per sample bundle, which is exactly the old
  linear planner's "parallel stage" behavior — ``sim → post`` costs one
  task per bundle, not two.
* **Instances** — each node expands over the study parameters *projected*
  onto its ``params`` subset (ordered dedup; ``params: []`` → a single
  instance, ``params: None`` → every combo).  The instance index is what
  the wire payloads call ``combo``.
* **Edges** — resolved to the instance level.  A plain edge matches
  parent/child instances on the parameter keys both sides share (same
  combo when they share everything, broadcast fan-out/fan-in when the
  child adds or drops keys, all-to-all when they share nothing); a
  ``_*`` edge funnels every parent instance into every child instance.

Diamonds, fan-in, fan-out, and per-node queue/handler annotations all
fall out of this representation; the old ``plan_stages`` list could
express none of them.  Validation raises :class:`~repro_torch.core.spec.SpecError`
with real messages — never a bare assert.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .spec import SpecError, Step, StudySpec, expand_parameters, strip_zip, topo_order

NodeInst = Tuple[int, int]  # (node index, instance index)


@dataclasses.dataclass
class DagEdge:
    src: int               # parent node index
    dst: int               # child node index
    funnel: bool = False   # True for "parent_*": all parent instances


@dataclasses.dataclass
class DagNode:
    idx: int
    steps: List[Step]                      # ≥1; >1 when chain-fused
    kind: str                              # "parallel" (per-bundle) | "single"
    params: Optional[Tuple[str, ...]]      # projected param keys; None = all
    sample_set: str
    queue: Optional[str]
    handler: str
    max_retries: int
    resources: Dict[str, Any]
    timeout: Optional[float] = None        # per-execution wall clock
    on_failure: str = "retry"              # action at retry exhaustion
    instances: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    in_edges: List[DagEdge] = dataclasses.field(default_factory=list)
    out_edges: List[DagEdge] = dataclasses.field(default_factory=list)

    @property
    def name(self) -> str:
        return "+".join(s.name for s in self.steps)

    def param_keys(self, all_keys: Sequence[str]) -> Tuple[str, ...]:
        return tuple(all_keys) if self.params is None else self.params


@dataclasses.dataclass
class TaskDag:
    spec: StudySpec
    nodes: List[DagNode]
    combos: List[Dict[str, Any]]           # full study-level expansion
    node_of_step: Dict[str, int]

    # -- instance-level graph -------------------------------------------------

    def instance_parents(self, nidx: int, iidx: int) -> List[NodeInst]:
        """Every (node, instance) that must complete before (nidx, iidx)."""
        node = self.nodes[nidx]
        child = node.instances[iidx]
        out: List[NodeInst] = []
        for e in node.in_edges:
            parent = self.nodes[e.src]
            if e.funnel:
                out.extend((e.src, i) for i in range(len(parent.instances)))
                continue
            all_keys = self._all_keys()
            shared = set(parent.param_keys(all_keys)) & set(node.param_keys(all_keys))
            for i, pinst in enumerate(parent.instances):
                if all(pinst[k] == child[k] for k in shared):
                    out.append((e.src, i))
        return out

    def instance_children(self, nidx: int, iidx: int) -> List[NodeInst]:
        """Every (node, instance) that waits on (nidx, iidx) — the out-edge
        set a completing worker must consider unlocking."""
        out: List[NodeInst] = []
        for e in self.nodes[nidx].out_edges:
            child = self.nodes[e.dst]
            for j in range(len(child.instances)):
                if (nidx, iidx) in self.instance_parents(e.dst, j):
                    out.append((e.dst, j))
        return out

    def indegree(self, nidx: int, iidx: int) -> int:
        return len(self.instance_parents(nidx, iidx))

    def roots(self) -> List[NodeInst]:
        return [(n.idx, i) for n in self.nodes
                for i in range(len(n.instances)) if not n.in_edges]

    def all_instances(self) -> List[NodeInst]:
        return [(n.idx, i) for n in self.nodes
                for i in range(len(n.instances))]

    def kinds(self) -> List[str]:
        return [n.kind for n in self.nodes]

    def _all_keys(self) -> Tuple[str, ...]:
        return tuple(sorted(strip_zip(k) for k in self.spec.parameters))

    # -- persistence ----------------------------------------------------------

    def to_doc(self) -> Dict[str, Any]:
        """A JSON-able structural summary for the persisted state file —
        enough for ``merlin-status`` / ``attach`` to name nodes without
        re-deserializing the spec."""
        return {
            "study": self.spec.name,
            "nodes": [{
                "idx": n.idx,
                "name": n.name,
                "steps": [s.name for s in n.steps],
                "kind": n.kind,
                "handler": n.handler,
                "queue": n.queue,
                "sample_set": n.sample_set,
                "max_retries": n.max_retries,
                "timeout": n.timeout,
                "on_failure": n.on_failure,
                "n_instances": len(n.instances),
                "in": [[e.src, e.funnel] for e in n.in_edges],
                "out": [[e.dst, e.funnel] for e in n.out_edges],
            } for n in self.nodes],
        }


def _project(combos: List[Dict[str, Any]],
             keys: Optional[Tuple[str, ...]]) -> List[Dict[str, Any]]:
    """Ordered-dedup projection of the full combo list onto ``keys``."""
    if keys is None:
        return [dict(c) for c in combos]
    seen = set()
    out: List[Dict[str, Any]] = []
    for c in combos:
        proj = {k: c[k] for k in keys}
        sig = tuple(proj[k] for k in keys)
        if sig not in seen:
            seen.add(sig)
            out.append(proj)
    return out


def _fuse_key(s: Step) -> Tuple:
    # timeout/on_failure are part of the key: steps with different failure
    # policies must not chain-fuse into one node (a fused node has exactly
    # one policy).
    return (s.queue, s.handler_name(), s.sample_set, s.params,
            tuple(sorted(s.resources.items())), s.timeout, s.on_failure)


def compile_dag(spec: StudySpec,
                combos: Optional[List[Dict[str, Any]]] = None) -> TaskDag:
    """Validate ``spec`` and lower it to a :class:`TaskDag`.

    Raises :class:`~repro_torch.core.spec.SpecError` on any structural problem;
    the message names the offending step and rule.
    """
    spec.validate()
    order = topo_order(spec)
    by_name = {s.name: s for s in order}

    # step-level edge lists (dep name, funnel flag)
    step_parents: Dict[str, List[Tuple[str, bool]]] = {}
    out_degree: Dict[str, int] = {s.name: 0 for s in order}
    for s in order:
        plist: List[Tuple[str, bool]] = []
        seen_dep = set()
        for d in s.depends:
            funnel = d.endswith("_*")
            base = d[:-2] if funnel else d
            if base in seen_dep:
                raise SpecError(
                    f"step '{s.name}': duplicate dependency on '{base}'")
            seen_dep.add(base)
            plist.append((base, funnel))
            out_degree[base] += 1
        step_parents[s.name] = plist

    # -- chain fusion: append step to its single plain parent's node when the
    # parent is that node's tail, has out-degree 1, and routing matches.
    nodes: List[DagNode] = []
    node_of_step: Dict[str, int] = {}
    for s in order:
        plist = step_parents[s.name]
        fused = False
        if (s.over_samples and len(plist) == 1 and not plist[0][1]
                and out_degree[plist[0][0]] == 1):
            pname = plist[0][0]
            parent_step = by_name[pname]
            pnode = nodes[node_of_step[pname]]
            if (parent_step.over_samples
                    and pnode.steps[-1].name == pname
                    and _fuse_key(parent_step) == _fuse_key(s)):
                pnode.steps.append(s)
                pnode.max_retries = max(pnode.max_retries, s.max_retries)
                node_of_step[s.name] = pnode.idx
                fused = True
        if not fused:
            nodes.append(DagNode(
                idx=len(nodes),
                steps=[s],
                kind="parallel" if s.over_samples else "single",
                params=s.params,
                sample_set=s.sample_set,
                queue=s.queue,
                handler=s.handler_name(),
                max_retries=s.max_retries,
                resources=dict(s.resources),
                timeout=s.timeout,
                on_failure=s.on_failure,
            ))
            node_of_step[s.name] = nodes[-1].idx

    # -- node-level edges (skip intra-node chain edges, dedup parallel edges)
    edge_seen: Dict[Tuple[int, int], DagEdge] = {}
    for s in order:
        dst = node_of_step[s.name]
        for base, funnel in step_parents[s.name]:
            src = node_of_step[base]
            if src == dst:
                continue  # fused chain edge
            key = (src, dst)
            if key in edge_seen:
                # funnel wins: it is the weaker (superset) wait
                edge_seen[key].funnel = edge_seen[key].funnel or funnel
                continue
            e = DagEdge(src=src, dst=dst, funnel=funnel)
            edge_seen[key] = e
            nodes[src].out_edges.append(e)
            nodes[dst].in_edges.append(e)

    combos = expand_parameters(spec) if combos is None else combos
    for n in nodes:
        n.instances = _project(combos, n.params)
        if not n.instances:
            n.instances = [{}]

    dag = TaskDag(spec=spec, nodes=nodes, combos=combos,
                  node_of_step=node_of_step)

    # -- arity validation: every non-root instance must have ≥1 parent
    # instance, or it would deadlock forever.
    for n in nodes:
        if not n.in_edges:
            continue
        for i in range(len(n.instances)):
            if not dag.instance_parents(n.idx, i):
                raise SpecError(
                    f"step '{n.name}' instance {n.instances[i]!r} matches no "
                    f"parent instance on its dependency edges — it would "
                    f"never unlock (check 'params' subsets or use a "
                    f"'_*' funnel)")
    return dag
