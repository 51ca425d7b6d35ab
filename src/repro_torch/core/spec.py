"""Study specification — the Maestro-YAML-like interface (paper Sec. 2.2).

A study has named *steps* with shell commands (``cmd``) or registered Python
callables (``fn``), DAG dependencies (``depends``), Maestro-style
*parameters* (expanded combinatorially into the DAG) and Merlin's *samples*
(huge embarrassingly-parallel index space, expanded lazily through the task
hierarchy — Fig. 1's layering).  ``$(NAME)`` tokens in commands are
substituted from parameters / sample columns / workspace variables.

Dependency edges come in two flavors (both Maestro idioms):

* ``depends: ["step"]`` — a *matched* edge: each instance of the child
  waits for the parent instances whose parameter values agree on the
  keys both steps share (per-combo when they share all keys, a broadcast
  fan-out/fan-in when they share only some, everything when they share
  none).
* ``depends: ["step_*"]`` — a *funnel*: every instance of the child waits
  for **all** instances of the parent.

Steps may restrict which parameters they expand over (``params``), pick a
named sample set (``sample_set`` — producers publish extra sets at run
time via ``ctx.publish_samples``), route to a dedicated queue (``queue``),
and choose an execution handler (``handler``: ``fn`` / ``subprocess`` /
``scheduler`` — see ``core/handlers.py``).  The spec is *compiled* into an
explicit task-graph IR by ``core/dag.py``; nothing here executes.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Tuple

import yaml

ZIP_SUFFIX = "%zip"

#: Legal per-step ``on_failure`` actions (applied once the retry budget is
#: exhausted): re-queue and eventually poison (``retry``, the default),
#: move to the step's ``dlq.<queue>`` dead-letter queue (``dead_letter``),
#: mark the instance complete so children unlock (``skip``), or halt the
#: whole study and drain its pending instances (``halt_study``).
ON_FAILURE_MODES = ("retry", "dead_letter", "skip", "halt_study")


class SpecError(ValueError):
    """A study spec failed validation; the message says which rule and where."""


@dataclasses.dataclass
class Step:
    name: str
    cmd: Optional[str] = None          # shell command template
    fn: Optional[str] = None           # name in the runtime's fn-registry
    shell: str = "/bin/bash"           # per-step shell (paper's extension)
    depends: Tuple[str, ...] = ()
    over_samples: bool = True          # runs per sample bundle vs once
    max_retries: int = 2
    params: Optional[Tuple[str, ...]] = None  # None = expand over all params
    sample_set: str = "default"        # which published sample set to iterate
    queue: Optional[str] = None        # route to a dedicated broker queue
    handler: Optional[str] = None      # execution handler; None = infer
    resources: Dict[str, Any] = dataclasses.field(default_factory=dict)
    timeout: Optional[float] = None    # wall-clock seconds per execution
    on_failure: str = "retry"          # action once retries are exhausted

    def handler_name(self) -> str:
        """The effective handler: explicit, else inferred from fn/cmd."""
        if self.handler:
            return self.handler
        return "fn" if self.fn else "subprocess"


@dataclasses.dataclass
class StudySpec:
    name: str
    steps: List[Step]
    parameters: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)
    variables: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def step(self, name: str) -> Step:
        for s in self.steps:
            if s.name == name:
                return s
        raise KeyError(name)

    def validate(self) -> None:
        """Raise :class:`SpecError` with a pointed message on the first
        violated rule (duplicate names, unknown deps/params, cycles...)."""
        if not self.steps:
            raise SpecError(f"study '{self.name}' has no steps")
        names = [s.name for s in self.steps]
        seen = set()
        for n in names:
            if n in seen:
                raise SpecError(
                    f"study '{self.name}': duplicate step name '{n}'")
            seen.add(n)
        param_keys = set(strip_zip(k) for k in self.parameters)
        for s in self.steps:
            if s.cmd is None and s.fn is None:
                raise SpecError(
                    f"step '{s.name}': needs either 'cmd' or 'fn'")
            for d in s.depends:
                base = d[:-2] if d.endswith("_*") else d
                if base not in seen:
                    raise SpecError(
                        f"step '{s.name}': depends on unknown step '{base}' "
                        f"(known steps: {', '.join(names)})")
                if base == s.name:
                    raise SpecError(
                        f"step '{s.name}': depends on itself")
            if s.on_failure not in ON_FAILURE_MODES:
                raise SpecError(
                    f"step '{s.name}': on_failure must be one of "
                    f"{', '.join(ON_FAILURE_MODES)}, got '{s.on_failure}'")
            if s.timeout is not None and s.timeout <= 0:
                raise SpecError(
                    f"step '{s.name}': timeout must be positive, "
                    f"got {s.timeout}")
            if s.max_retries < 0:
                raise SpecError(
                    f"step '{s.name}': retries must be >= 0, "
                    f"got {s.max_retries}")
            if s.params is not None:
                for p in s.params:
                    if p not in param_keys:
                        raise SpecError(
                            f"step '{s.name}': params names unknown "
                            f"parameter '{p}' (declared: "
                            f"{', '.join(sorted(param_keys)) or 'none'})")
        order = topo_order(self)
        if len(order) != len(self.steps):
            stuck = [n for n in names if n not in {s.name for s in order}]
            raise SpecError(
                f"study '{self.name}': dependency cycle involving step(s) "
                f"{', '.join(stuck)}")
        zip_lens = {k: len(v) for k, v in self.parameters.items()
                    if k.endswith(ZIP_SUFFIX)}
        if zip_lens and len(set(zip_lens.values())) > 1:
            raise SpecError(
                f"study '{self.name}': %zip parameter lists must have equal "
                f"lengths, got { {strip_zip(k): n for k, n in zip_lens.items()} }")

    @staticmethod
    def from_yaml(text: str) -> "StudySpec":
        doc = yaml.safe_load(text)
        if not isinstance(doc, dict):
            raise SpecError("spec document is not a YAML mapping")
        steps = []
        for sd in doc.get("study", []):
            run = sd.get("run", {})
            params = run.get("params")
            steps.append(Step(
                name=sd["name"],
                cmd=run.get("cmd"),
                fn=run.get("fn"),
                shell=run.get("shell", "/bin/bash"),
                depends=tuple(run.get("depends", ())),
                over_samples=bool(run.get("samples", True)),
                max_retries=int(run.get("retries",
                                        run.get("max_retries", 2))),
                params=tuple(params) if params is not None else None,
                sample_set=str(run.get("sample_set", "default")),
                queue=run.get("queue"),
                handler=run.get("handler"),
                resources=dict(run.get("resources", {}) or {}),
                timeout=(float(run["timeout"])
                         if run.get("timeout") is not None else None),
                on_failure=str(run.get("on_failure", "retry")),
            ))
        params = {k: v["values"] if isinstance(v, dict) else v
                  for k, v in (doc.get("global.parameters") or {}).items()}
        return StudySpec(
            name=doc.get("description", {}).get("name", "study"),
            steps=steps, parameters=params,
            variables=(doc.get("env", {}) or {}).get("variables", {}) or {})


def strip_zip(key: str) -> str:
    return key[:-len(ZIP_SUFFIX)] if key.endswith(ZIP_SUFFIX) else key


def topo_order(spec: StudySpec) -> List[Step]:
    done: List[Step] = []
    names_done: set = set()
    pending = list(spec.steps)
    while pending:
        progressed = False
        for s in list(pending):
            deps = {d[:-2] if d.endswith("_*") else d for d in s.depends}
            if deps <= names_done:
                done.append(s)
                names_done.add(s.name)
                pending.remove(s)
                progressed = True
        if not progressed:
            break  # cycle; validate() reports the stuck steps
    return done


def expand_parameters(spec: StudySpec) -> List[Dict[str, Any]]:
    """Expansion of the DAG parameters (Fig. 1's discrete values).

    Keys declared with a ``%zip`` suffix expand *zipped* — position i of
    every zipped list forms one combo slice (lists must have equal
    lengths) — and the zipped slice is crossed with the full Cartesian
    product of the remaining keys.  The suffix is stripped in the
    resulting combo dicts.
    """
    if not spec.parameters:
        return [{}]
    zip_keys = sorted(k for k in spec.parameters if k.endswith(ZIP_SUFFIX))
    prod_keys = sorted(k for k in spec.parameters if not k.endswith(ZIP_SUFFIX))
    zip_slices: List[Dict[str, Any]] = [{}]
    if zip_keys:
        lens = {len(spec.parameters[k]) for k in zip_keys}
        if len(lens) > 1:
            raise SpecError(
                f"%zip parameter lists must have equal lengths, got "
                f"{ {strip_zip(k): len(spec.parameters[k]) for k in zip_keys} }")
        n = lens.pop()
        zip_slices = [{strip_zip(k): spec.parameters[k][i] for k in zip_keys}
                      for i in range(n)]
    combos = []
    for zs in zip_slices:
        for vals in itertools.product(*(spec.parameters[k] for k in prod_keys)):
            combo = dict(zs)
            combo.update(zip(prod_keys, vals))
            combos.append(combo)
    return combos


def substitute(template: str, env: Dict[str, Any]) -> str:
    out = template
    for k, v in env.items():
        out = out.replace(f"$({k})", str(v))
    return out
