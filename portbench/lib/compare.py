"""The numbers that decide ``correct``, and the decision.

Training: the loss of each step the reference follows, as a share of
the reference's; the first step's global gradient norm before the clip
likewise; and by the worst leaf, the norm of the first gradient as the optimizer got it and the
norm of each leaf's change over those steps: the gap between the
program's norm and the reference's, over the reference's norm of that
leaf or of the median leaf, whichever is larger.  Leaves whose reference
gradient is under a thousandth of the median leaf's move under AdamW by
round-off (and weight decay) alone: they are left out of the change.
Besides, over the other leaves, the first gradient's gap over the leaf's
own norm (``grad_own_gap``): a leaf whose gradient is far below the
median's, as the decays' are, is then judged by its own size.

Serving: for each checked served token, how far the reference's logit
of it lies below the reference's best at that position; the widest gap.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Optional, Tuple

NOUGHT = 1e-3  # a leaf's gradient under this share of the median leaf's


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep=None, own=False) -> Tuple[float, Optional[str]]:
    """The worst leaf's gap over the larger of its reference norm and the
    median leaf's, or with ``own`` over its reference norm alone."""
    names = [k for k in ref if keep is None or k in keep]
    med = 0.0 if own else statistics.median(ref[k] for k in names)
    worst, leaf = 0.0, None
    for k in names:
        g = abs(prog[k] - ref[k]) / max(ref[k], med)
        if not g <= worst:  # NaN counts as worst
            worst, leaf = g, k
            if math.isnan(g):
                break
    return worst, leaf


def moving_leaves(ref_grad: Dict[str, float]) -> set:
    med = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v >= NOUGHT * med}


def train_numbers(prog: dict, ref: dict) -> Dict[str, dict]:
    """{number: {"value", "worst_leaf"?}} from two ``follow``-shaped
    records ({"loss", "grad_norm", "grad_leaf", "change_leaf"})."""
    loss = max(rel_gap(a, b) for a, b in zip(prog["loss"], ref["loss"]))
    moving = moving_leaves(ref["grad_leaf"])
    grad, gleaf = worst_leaf(prog["grad_leaf"], ref["grad_leaf"])
    own, oleaf = worst_leaf(prog["grad_leaf"], ref["grad_leaf"], moving,
                            own=True)
    change, cleaf = worst_leaf(prog["change_leaf"], ref["change_leaf"],
                               moving)
    return {"loss_gap": {"value": loss},
            "grad_norm_gap": {"value": rel_gap(prog["grad_norm"],
                                               ref["grad_norm"])},
            "grad_leaf_gap": {"value": grad, "leaf": gleaf},
            "grad_own_gap": {"value": own, "leaf": oleaf},
            "change_leaf_gap": {"value": change, "leaf": cleaf}}


def decide(numbers: Dict[str, dict], limits: Dict[str, dict]):
    """(correct, checks): every number that has a limit, finite and at
    most it, each beside its limit.  A number without a limit in the
    cell's file is not compared (its readings could only fail sound runs;
    ``PERF.md`` names it)."""
    checks, ok = {}, True
    for name, n in numbers.items():
        if name in limits:
            checks[name] = dict(n, limit=limits[name]["limit"])
            ok &= math.isfinite(n["value"]) and n["value"] <= checks[name]["limit"]
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"limits for numbers the run does not read: {missing}")
    return ok, checks
