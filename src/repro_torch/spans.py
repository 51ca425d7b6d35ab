"""Spans inside the port's steps: which phase, layer or host activity the
device's time belongs to.

``span(name, phase)`` is a context manager around a phase or a layer of
the training and decode steps; ``step(name, phase)`` is the one around a
whole step, its anchor.  They record only while a ``torch.profiler``
session is active (torch's module-level ``_is_profiler_enabled``, which
torch sets for any set of activities); there is no other switch.  When off
a span costs that one test and records nothing: no CUDA event is created
and no gradient hook is registered.

When on, each span records its name, its phase, its parent, the thread it
opened on, its host open and close times (``time.time_ns()``, Unix ns) and,
on a card, a pair of timing events recorded on the current stream.  On a
card the autograd engine runs gradient hooks and remat's recompute on a
thread of its own, so every thread keeps its own stack of open spans; a
span that opens on a thread with none open takes as parent the innermost
open span of the thread that opened the step.

The anchor synchronises the device, takes the host's Unix time, and
records an event: every event's device time is then that time plus its
``elapsed_time`` from the anchor's event.  Where the step before ends in a
synchronisation of its own (a loss or the tokens read on the host) the
anchor costs nothing; elsewhere, while a profiler is active, it removes
the overlap of one step's device work with the next step's host work.

Phases: a span takes the phase it is given, else ``recompute`` when it
opens while a graph task runs (remat's recompute of a layer inside the
backward), else its parent's (its own name at the top).  The backward of
each layer is a span ``<layer>.backward`` (phase ``backward``) that
:class:`LayerBackward`'s gradient hooks open when the layer's output's
gradient is complete and close when its input's is.

Records are kept after the session, for readers that resolve them once the
device's work is complete (:meth:`Recorder.resolve`), as the kernel
wrappers' launch counters are read after a run; a step that runs untraced
marks them done, and the next traced step starts them anew.  The
benchmark's ``portbench/lib/spans.py`` joins them with its device trace.
"""
from __future__ import annotations

import contextlib
import threading
import time
from functools import partial
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    """A resolved record.  Times are Unix ns; the device's are None off a
    card or outside any step.  ``parent`` is an index into the same list,
    or -1."""
    name: str
    phase: str
    parent: int
    thread: int
    host_open: int
    host_close: Optional[int]
    dev_open: Optional[int]
    dev_close: Optional[int]
    anchor: bool


class _Record:
    __slots__ = ("index", "name", "phase", "parent", "thread", "host_open",
                 "host_close", "ev_open", "ev_close", "anchor")

    def __init__(self, index, name, phase, parent, thread, anchor):
        self.index, self.name, self.phase = index, name, phase
        self.parent, self.thread, self.anchor = parent, thread, anchor
        self.host_open = self.host_close = None
        self.ev_open = self.ev_close = None


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Recorder:
    """The spans of the current or last profiler session."""

    def __init__(self):
        self.records: List[_Record] = []
        self.stacks: Dict[int, List[_Record]] = {}
        self.anchor: Optional[_Record] = None
        self.done = False
        self.lock = threading.Lock()  # the step's and autograd's threads

    def open(self, name: str, phase: Optional[str] = None,
             anchor: bool = False) -> _Record:
        me = threading.get_ident()
        if anchor:
            if self.done:
                self.records, self.done = [], False
            self.stacks = {}
        stack = self.stacks.setdefault(me, [])
        parent = stack[-1] if stack else self._step_top()
        if phase is None:
            phase = ("recompute" if torch._C._current_graph_task_id() != -1
                     else parent.phase if parent is not None else name)
        timed = torch.cuda.is_initialized()  # on a card
        with self.lock:
            r = _Record(len(self.records), name, phase,
                        -1 if parent is None else parent.index, me, anchor)
            self.records.append(r)
        if anchor:
            if timed:
                torch.cuda.synchronize()
            self.anchor = r
        r.host_open = time.time_ns()
        if timed:
            r.ev_open = _event()
        stack.append(r)
        return r

    def _step_top(self) -> Optional[_Record]:
        """The innermost open span of the thread that opened the step."""
        if self.anchor is None or self.anchor.host_close is not None:
            return None
        stack = self.stacks.get(self.anchor.thread)
        return stack[-1] if stack else None

    def close(self, r: _Record) -> None:
        if r.ev_open is not None:
            r.ev_close = _event()
        r.host_close = time.time_ns()
        stack = self.stacks.get(r.thread, [])
        if r in stack:
            del stack[stack.index(r):]

    def resolve(self) -> List[Span]:
        """The records with their device times, once the device's work is
        complete (this synchronises)."""
        if any(r.ev_open is not None for r in self.records):
            torch.cuda.synchronize()
        out, anchor = [], None
        for r in self.records:
            if r.anchor:
                anchor = r
            dev = (None, None)
            if (anchor is not None and r.ev_open is not None
                    and anchor.ev_open is not None):
                dev = tuple(None if ev is None else anchor.host_open + round(
                    1e6 * anchor.ev_open.elapsed_time(ev))
                    for ev in (r.ev_open, r.ev_close))
            out.append(Span(r.name, r.phase, r.parent, r.thread, r.host_open,
                            r.host_close, dev[0], dev[1], r.anchor))
        return out


RECORDER = Recorder()


@contextlib.contextmanager
def _recorded(name, phase, anchor):
    r = RECORDER.open(name, phase, anchor)
    try:
        yield
    finally:
        RECORDER.close(r)


def span(name: str, phase: Optional[str] = None):
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _recorded(name, phase, False)


def step(name: str, phase: str):
    """The span of a whole step, its anchor."""
    if not _profiler._is_profiler_enabled:
        RECORDER.done = True
        return _OFF
    return _recorded(name, phase, True)


def layer_backward() -> Optional["LayerBackward"]:
    """Gradient hooks for the layers' backward spans while recording and
    differentiating, else None."""
    if not _profiler._is_profiler_enabled or not torch.is_grad_enabled():
        return None
    return LayerBackward()


class LayerBackward:
    """The boundaries between a stack's layers, each a tensor: layer i's
    input, which is layer i-1's output; and after the last layer its
    output.  The hook on boundary i runs once the tensor's gradient is
    complete: it closes layer i's backward span, then opens layer i-1's,
    in that order, on the thread that runs the backward."""

    def __init__(self):
        self.names: List[Optional[str]] = []
        self.open: Dict[int, _Record] = {}

    def boundary(self, t: torch.Tensor, name: Optional[str] = None) -> None:
        """``t`` is the input of layer ``name`` (None: the last layer's
        output)."""
        i = len(self.names)
        self.names.append(name)
        if t.requires_grad:
            t.register_hook(partial(self._at, i))

    def _at(self, i: int, grad) -> None:
        r = self.open.pop(i, None)
        if r is not None:
            RECORDER.close(r)
        if i > 0 and _profiler._is_profiler_enabled:
            self.open[i - 1] = RECORDER.open(
                self.names[i - 1] + ".backward", "backward")
