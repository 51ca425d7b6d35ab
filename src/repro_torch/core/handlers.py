"""Pluggable execution handlers — HOW a step's work actually runs.

The DAG decides *what* runs *when*; an :class:`ExecutionHandler` decides
the mechanism.  The paper's Merlin spans three tiers and this module
mirrors them:

* :class:`FnStepHandler` (``handler: fn``) — in-process Python callables
  from the runtime's fn-registry.  ``inprocess=True`` marks these as
  fusable: the worker routes them through the shared
  :class:`~repro_torch.core.engine.ExecutionEngine` micro-batcher, exactly as
  before this layer existed.
* :class:`SubprocessHandler` (``handler: subprocess``) — local shell
  command steps, one subprocess per bundle in the worker's own thread
  (N workers really do mean N concurrent simulations).
* :class:`SchedulerJobHandler` (``handler: scheduler``) — the
  flux/slurm batch tier: render the command to a job script, submit it
  to a :class:`Scheduler`, poll to completion.  :class:`MockScheduler`
  (the default) fakes the scheduler with a local process table so tests
  exercise the full submit→poll→collect path without a real batch
  system; swap in a real ``Scheduler`` via
  ``runtime.register_handler(SchedulerJobHandler(MyFluxScheduler()))``.

Steps pick a handler by name in the spec (``run: {handler: ...}``); the
default is ``fn`` for fn-steps and ``subprocess`` for cmd-steps, which
reproduces the old hard-coded split.  Workers never special-case fn vs
cmd anymore — they ask the runtime, and the runtime asks the handler
(``inprocess`` drives engine routing, ``execute`` does the work).
"""
from __future__ import annotations

import os
import subprocess
import threading
import time
import uuid
from typing import Any, Dict, Optional, Protocol, runtime_checkable

from .spec import Step, substitute


class HandlerError(RuntimeError):
    """A step's execution mechanism failed (bad handler, failed job...)."""


def render_script(step: Step, ctx) -> str:
    """Substitute ``$(NAME)`` tokens and write the step's shell script into
    the bundle workspace; returns the script path.  Shared by every
    command-based handler so env/layout conventions cannot drift."""
    env = {**ctx.variables, **ctx.combo,
           "SAMPLE_LO": ctx.lo, "SAMPLE_HI": ctx.hi,
           "WORKSPACE": ctx.workspace, "MERLIN_STUDY": ctx.study}
    cmd = substitute(step.cmd or "", env)
    script = os.path.join(ctx.workspace, f"{step.name}.sh")
    with open(script, "w") as f:
        f.write(cmd if cmd.endswith("\n") else cmd + "\n")
    return script


@runtime_checkable
class ExecutionHandler(Protocol):
    name: str
    inprocess: bool  # True → fusable through the shared ExecutionEngine

    def execute(self, runtime, step: Step, ctx) -> None:
        """Run one step for one bundle context; raise on failure."""
        ...


class FnStepHandler:
    """In-process callable from the runtime's fn-registry."""

    name = "fn"
    inprocess = True

    def execute(self, runtime, step: Step, ctx) -> None:
        if step.fn is None:
            raise HandlerError(f"step '{step.name}': handler 'fn' needs fn")
        try:
            fn = runtime.fns[step.fn]
        except KeyError:
            raise HandlerError(
                f"step '{step.name}': fn '{step.fn}' is not registered "
                f"(known: {', '.join(sorted(runtime.fns)) or 'none'})")
        fn(ctx)


class SubprocessHandler:
    """Local shell command, one subprocess per bundle."""

    name = "subprocess"
    inprocess = False

    def __init__(self, timeout: float = 600.0):
        self.timeout = timeout

    def execute(self, runtime, step: Step, ctx) -> None:
        if step.cmd is None:
            raise HandlerError(
                f"step '{step.name}': handler 'subprocess' needs cmd")
        script = render_script(step, ctx)
        # per-step `timeout:` overrides the handler default; subprocess.run
        # kills the child at the deadline (the wall-clock kill), and the
        # typed HandlerError routes into the normal retry/on_failure path
        timeout = step.timeout if step.timeout is not None else self.timeout
        try:
            res = subprocess.run([step.shell, script], cwd=ctx.workspace,
                                 capture_output=True, text=True,
                                 timeout=timeout)
        except subprocess.TimeoutExpired:
            raise HandlerError(
                f"step {step.name} timed out after {timeout}s (killed)")
        if res.returncode != 0:
            raise HandlerError(
                f"step {step.name} failed rc={res.returncode}: "
                f"{res.stderr[-500:]}")


# -- batch-scheduler tier ----------------------------------------------------

@runtime_checkable
class Scheduler(Protocol):
    """Minimal batch-scheduler surface (the flux/slurm adapter point)."""

    def submit(self, script: str, cwd: str,
               resources: Dict[str, Any]) -> str:
        """Submit a job script; returns an opaque job id."""
        ...

    def status(self, job_id: str) -> str:
        """One of PENDING / RUNNING / COMPLETED / FAILED."""
        ...

    def cancel(self, job_id: str) -> None: ...


class MockScheduler:
    """A fake batch scheduler backed by a local process table.

    Jobs run as real subprocesses but go through the full
    submit→PENDING→RUNNING→COMPLETED/FAILED lifecycle, so the handler's
    polling loop is exercised end-to-end in tests.  ``hold_s`` keeps a
    job PENDING for a while — useful for asserting the polling path."""

    def __init__(self, shell: str = "/bin/bash", hold_s: float = 0.0):
        self.shell = shell
        self.hold_s = hold_s
        self.jobs: Dict[str, Dict[str, Any]] = {}
        self.submitted = 0
        self._lock = threading.Lock()

    def submit(self, script: str, cwd: str,
               resources: Dict[str, Any]) -> str:
        job_id = f"mock-{uuid.uuid4().hex[:8]}"
        with self._lock:
            self.submitted += 1
            self.jobs[job_id] = {"script": script, "cwd": cwd,
                                 "resources": dict(resources),
                                 "t0": time.monotonic(), "proc": None}
        return job_id

    def _maybe_start(self, job: Dict[str, Any]) -> None:
        if job["proc"] is None and \
                time.monotonic() - job["t0"] >= self.hold_s:
            job["proc"] = subprocess.Popen(
                [self.shell, job["script"]], cwd=job["cwd"],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)

    def status(self, job_id: str) -> str:
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None:
                raise HandlerError(f"unknown job id {job_id}")
            self._maybe_start(job)
            proc = job["proc"]
            if proc is None:
                return "PENDING"
            rc = proc.poll()
            if rc is None:
                return "RUNNING"
            if "stderr" not in job:  # drain + close the pipe exactly once
                job["stderr"] = proc.stderr.read().decode(
                    "utf-8", "replace") if proc.stderr else ""
                if proc.stderr:
                    proc.stderr.close()
            return "COMPLETED" if rc == 0 else "FAILED"

    def cancel(self, job_id: str) -> None:
        with self._lock:
            job = self.jobs.get(job_id)
            if job and job["proc"] is not None and \
                    job["proc"].poll() is None:
                job["proc"].kill()


class SchedulerJobHandler:
    """Run a cmd-step as a batch-scheduler job: render script, submit with
    the step's ``resources`` annotation, poll until terminal."""

    name = "scheduler"
    inprocess = False

    def __init__(self, scheduler: Optional[Scheduler] = None,
                 poll_s: float = 0.02, timeout: float = 600.0):
        self.scheduler = scheduler or MockScheduler()
        self.poll_s = poll_s
        self.timeout = timeout

    def execute(self, runtime, step: Step, ctx) -> None:
        if step.cmd is None:
            raise HandlerError(
                f"step '{step.name}': handler 'scheduler' needs cmd")
        script = render_script(step, ctx)
        job_id = self.scheduler.submit(script, ctx.workspace,
                                       step.resources)
        timeout = step.timeout if step.timeout is not None else self.timeout
        deadline = time.monotonic() + timeout
        while True:
            st = self.scheduler.status(job_id)
            if st == "COMPLETED":
                return
            if st == "FAILED":
                raise HandlerError(
                    f"step {step.name}: scheduler job {job_id} FAILED")
            if time.monotonic() > deadline:
                self.scheduler.cancel(job_id)
                raise HandlerError(
                    f"step {step.name}: scheduler job {job_id} timed out")
            time.sleep(self.poll_s)


def default_handlers() -> Dict[str, ExecutionHandler]:
    """The registry every runtime starts with."""
    return {h.name: h for h in
            (FnStepHandler(), SubprocessHandler(), SchedulerJobHandler())}
