"""The measured window: whole steps until the time is up.

A step returns once its work is complete (its loss or its tokens are on
the host).  The window starts at a synchronised point and ends at the end
of the first step that finishes at or after ``seconds``, so every step in
it is counted whole and none is cut.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple


def run(step: Callable[[], None], seconds: float,
        clock: Callable[[], float] = time.monotonic,
        agree: Optional[Callable[[bool], bool]] = None
        ) -> Tuple[int, float, List[float]]:
    """(steps, window seconds, each step's end in seconds from the start).
    ``agree``: where several processes step together, the decision to
    step again made by one of them (``ranks.Group.agree``)."""
    t0 = clock()
    ends: List[float] = []
    while True:
        step()
        ends.append(clock() - t0)
        more = ends[-1] < seconds
        if agree is not None:
            more = agree(more)
        if not more:
            return len(ends), ends[-1], ends


def intervals(ends: List[float]) -> List[float]:
    """Each step's own time: from the previous step's end (the window's
    start for the first) to its end."""
    return [b - a for a, b in zip([0.0] + ends[:-1], ends)]

