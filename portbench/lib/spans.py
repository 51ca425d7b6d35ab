"""The program's spans (``repro_torch.spans``) joined with the device trace.

The trace's ``ts`` (µs) counts from a base that Kineto takes as the Unix
time rounded down to a multiple of 7,889,238 s; the spans carry Unix ns,
the device's from timing events anchored at each step's start.  So an
event lies on the spans' clock at ``ts`` + that base, computed from the
spans' own host times (a base that changed between the profiler's start
and the first step, once in three months, would put every event 91 days
away and leave the join empty).

Each device event is attributed by its midpoint: to every span whose
device interval holds it (a span's device seconds, by name and phase,
include its children's) and to the innermost such ``layer.*`` span (the
elementwise work by layer kind).  An idle gap is an interval between
device events, from the first step's anchor to the last event; it is put
down to the innermost host span open on any thread at that moment, or to
no span ("outside the program": the harness's feed and reads).

Without a card, or with a program that has no spans, there is nothing to
join and :func:`join` returns None.
"""
from __future__ import annotations

import bisect
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from portbench.lib import runner, trace

TRIMONTH_S = 7_889_238
OUTSIDE = "outside the program"
_JOINS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def base_ns(unix_ns: int) -> int:
    """The Unix ns from which a trace begun at ``unix_ns`` counts ``ts``."""
    return unix_ns // 10**9 // TRIMONTH_S * TRIMONTH_S * 10**9


@dataclass
class Join:
    steps: int
    device_s: Dict[Tuple[str, str], float] = field(default_factory=dict)
    busy_s: float = 0.0          # every device event's duration
    covered_s: float = 0.0       # under a step's span
    idle_s: Dict[str, float] = field(default_factory=dict)  # by host span
    layer_elementwise_s: Dict[str, float] = field(default_factory=dict)
    # each step's anchor: µs from the end of the event before it and to
    # the start of the next, and their names
    margins: List[Tuple[float, float, str, str]] = field(
        default_factory=list)

    def ms(self, name: str, phase: str) -> float:
        """Device ms a step under spans ``name`` of ``phase``."""
        return 1e3 * self.device_s.get((name, phase), 0.0) / self.steps

    def recompute_ms(self) -> float:
        return 1e3 * sum(s for (n, ph), s in self.device_s.items()
                         if ph == "recompute" and n.startswith("layer.")) \
            / self.steps

    def layer_elementwise_ms(self) -> float:
        return 1e3 * sum(self.layer_elementwise_s.values()) / self.steps

    def idle_in_program_ms(self) -> float:
        return 1e3 * sum(s for k, s in self.idle_s.items() if k != OUTSIDE) \
            / self.steps

    def readout(self) -> dict:
        per = 1e3 / self.steps
        step = sum(s for (n, ph), s in self.device_s.items()
                   if n in ("train_step", "decode_step"))
        phases = sum(s for (n, ph), s in self.device_s.items()
                     if n in ("forward", "backward", "grad_accum",
                              "optimizer"))
        return {
            "ms_a_step": {f"{n}/{ph}": round(s * per, 3) for (n, ph), s in
                          sorted(self.device_s.items(),
                                 key=lambda kv: -kv[1])},
            "coverage_pct": round(100 * self.covered_s / self.busy_s, 3),
            "phases_over_step": round(phases / step, 5) if phases else None,
            "idle_ms_a_step": {k: round(s * per, 3) for k, s in sorted(
                self.idle_s.items(), key=lambda kv: -kv[1])},
            "layer_elementwise_ms_a_step": {
                k: round(s * per, 3) for k, s in
                sorted(self.layer_elementwise_s.items())},
            "anchor_margins_us": [[round(a, 1), round(b, 1), p, n]
                                  for a, b, p, n in self.margins]}


def records():
    """The program's resolved spans, or None for a program without them."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.RECORDER.resolve()


def join(ctx) -> Optional[Join]:
    """The join of ``ctx.trace`` with the program's spans, computed once a
    trace and logged as one line (``spans``); None where there is nothing
    to join."""
    tr = ctx.trace
    if tr in _JOINS:
        return _JOINS[tr]
    spans = records() if tr.events else None
    out = compute(tr, spans, ctx.steps) if spans else None
    _JOINS[tr] = out
    if out is not None:
        runner.log("spans", out.readout())
    return out


def compute(tr: trace.Trace, spans, steps: int) -> Optional[Join]:
    """``spans`` as ``repro_torch.spans.Recorder.resolve`` gives them."""
    events = tr.events
    anchors = [s for s in spans if s.anchor and s.dev_open is not None]
    if not anchors or not events:
        return None
    base = base_ns(anchors[-1].host_open)

    def us(ns):
        return None if ns is None else (ns - base) / 1e3

    t_first = min(ts for _, ts, _ in events)
    t_last = max(ts + d for _, ts, d in events)
    # the steps inside the trace, and the spans opened under them
    kept = {i for i, s in enumerate(spans) if s.anchor and s.dev_open
            is not None and s.dev_close is not None
            and us(s.dev_open) < t_last and us(s.dev_close) > t_first}
    if not kept:
        return None
    own, cur = [], None
    for i, s in enumerate(spans):
        if s.anchor:
            cur = i if i in kept else None
        if cur is not None and s.dev_open is not None \
                and s.dev_close is not None:
            own.append(s)
    j = Join(steps=steps)

    # device seconds by span, through the events' midpoints
    mids = sorted((ts + d / 2, d, name) for name, ts, d in events)
    at = [m for m, _, _ in mids]
    run = [0.0]
    for _, d, _ in mids:
        run.append(run[-1] + d)
    j.busy_s = run[-1] / 1e6
    for s in own:
        a, b = bisect.bisect_left(at, us(s.dev_open)), \
            bisect.bisect_right(at, us(s.dev_close))
        sec = (run[b] - run[a]) / 1e6
        key = (s.name, s.phase)
        j.device_s[key] = j.device_s.get(key, 0.0) + sec
        if s.anchor:
            j.covered_s += sec

    # the elementwise work (neither a hand-written kernel nor a product) by
    # the innermost layer span
    layer = [s for s in own if s.name.startswith("layer.")]
    segs = _segments([(us(s.dev_open), us(s.dev_close)) for s in layer])
    groups = {}
    for m, d, name in mids:
        if name not in groups:
            groups[name] = trace.kernel_group(name)
        if groups[name] not in ("other", "copy_cast"):
            continue
        i = _locate(segs, m)
        if i is not None:
            kind = layer[i].name.split(".")[1]
            j.layer_elementwise_s[kind] = \
                j.layer_elementwise_s.get(kind, 0.0) + d / 1e6

    # idle gaps, by the innermost host span open on any thread
    busy = tr._spans()
    step_open = [us(spans[i].dev_open) for i in sorted(kept)]
    gaps = [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]
    if step_open[0] < busy[0][0]:
        gaps.insert(0, (step_open[0], busy[0][0]))
    host = [s for s in spans if s.host_close is not None]
    hsegs = _segments([(us(s.host_open), us(s.host_close)) for s in host])
    for g0, g1 in gaps:
        for a, b, who in _split(hsegs, g0, g1):
            key = OUTSIDE if who is None else host[who].name
            j.idle_s[key] = j.idle_s.get(key, 0.0) + (b - a) / 1e6

    # the clocks: each step's anchor in the idle gap its synchronise leaves,
    # between the event that ends last before it and the next to start
    starts = [ts for _, ts, _ in events]  # sorted, as a Trace holds them
    last, reach = [], None  # the event reaching furthest, by start
    for e in events:
        if reach is None or e[1] + e[2] > reach[1] + reach[2]:
            reach = e
        last.append(reach)
    for t in step_open:
        k = bisect.bisect_right(starts, t)
        prev = last[k - 1] if k else None
        nxt = events[k] if k < len(events) else None
        j.margins.append((
            t - prev[1] - prev[2] if prev else float("inf"),
            nxt[1] - t if nxt else float("inf"),
            prev[0][:96] if prev else "", nxt[0][:96] if nxt else ""))
    return j


def _segments(intervals) -> List[Tuple[float, float, int]]:
    """The intervals cut into pieces (start, end, index of the innermost
    interval over the piece: the one opened last), sorted."""
    cuts = sorted({t for iv in intervals for t in iv})
    order = sorted(range(len(intervals)), key=lambda i: intervals[i][0])
    out, live, k = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(order) and intervals[order[k]][0] <= a:
            live.append(order[k])
            k += 1
        live = [i for i in live if intervals[i][1] > a]
        if live:
            out.append((a, b, max(live, key=lambda i: intervals[i][0])))
    return out


def _locate(segs, t) -> Optional[int]:
    k = bisect.bisect_right(segs, (t, float("inf"), 0)) - 1
    if k >= 0 and segs[k][0] <= t < segs[k][1]:
        return segs[k][2]
    return None


def _split(segs, g0, g1):
    """[g0, g1) in pieces (a, b, innermost interval or None)."""
    k = max(0, bisect.bisect_right(segs, (g0, float("inf"), 0)) - 1)
    t = g0
    while t < g1:
        while k < len(segs) and segs[k][1] <= t:
            k += 1
        if k == len(segs) or segs[k][0] >= g1:
            yield t, g1, None
            return
        a, b, who = segs[k]
        if a > t:
            yield t, a, None
            t = a
        yield t, min(b, g1), who
        t = min(b, g1)
