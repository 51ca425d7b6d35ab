"""Plain training steps for the reference: the mean cross-entropy of a
batch, its gradients summed row by row, and AdamW with a clip on the
global norm (the clip before the moments, both moments bias-corrected,
``wd * p`` added to every leaf's step).

``follow`` runs the steps from given parameters and batches and returns
what the benchmark compares: each step's loss, the first step's gradient
norm before the clip, each leaf's norm of the first gradient after it (as
the optimizer gets it), and each leaf's change over the steps.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import lm


def grads(p: lm.Params, tokens, labels, m: dict, prec: lm.Precision,
          rows=None):
    """(loss, {name: gradient}) of the batch's mean loss, one row at a
    time.  ``rows`` (a slice) keeps part of the batch: the mean is then
    over those rows (a fault the harness's tests plant)."""
    if rows is not None:
        tokens, labels = tokens[rows], labels[rows]
    n = tokens.shape[0]
    for t in p.values():
        t.grad = None
    total = 0.0
    for b in range(n):
        loss = lm.loss(p, tokens[b:b + 1], labels[b:b + 1], m, prec) / n
        loss.backward()
        total += float(loss.detach())
    return total, {k: (t.grad if t.grad is not None else torch.zeros_like(t))
                   for k, t in p.items()}


@torch.no_grad()
def adamw(p: lm.Params, g: Dict[str, torch.Tensor], st: dict, o: dict):
    """One update in place; returns the global gradient norm before the
    clip and the clipped gradients."""
    st["step"] += 1
    gn = torch.sqrt(sum(torch.sum(x.square()) for x in g.values()))
    factor = torch.clamp_max(o["clip_norm"] / torch.clamp_min(gn, 1e-12), 1.0)
    b1t = 1 - o["b1"] ** st["step"]
    b2t = 1 - o["b2"] ** st["step"]
    clipped = {}
    for k, t in p.items():
        gk = g[k] * factor
        clipped[k] = gk
        m = st["m"].setdefault(k, torch.zeros_like(t))
        v = st["v"].setdefault(k, torch.zeros_like(t))
        m.mul_(o["b1"]).add_((1 - o["b1"]) * gk)
        v.mul_(o["b2"]).add_((1 - o["b2"]) * gk.square())
        t.sub_(o["lr"] * ((m / b1t) / (torch.sqrt(v / b2t) + o["eps"])
                          + o["wd"] * t))
    return float(gn), clipped


def follow(p0: lm.Params, batches: List[dict], m: dict, o: dict,
           prec: lm.Precision, rows=None) -> dict:
    """Train a copy of ``p0`` over ``batches`` ({"tokens", "labels"}).
    Returns {"loss": [..], "grad_norm": float, "grad_leaf": {name:
    norm}, "change_leaf": {name: norm}}."""
    p = {k: t.detach().clone().requires_grad_(True) for k, t in p0.items()}
    st = {"step": 0, "m": {}, "v": {}}
    out = {"loss": []}
    for i, b in enumerate(batches):
        loss, g = grads(p, b["tokens"], b["labels"], m, prec, rows)
        out["loss"].append(loss)
        gn, clipped = adamw(p, g, st, o)
        if i == 0:
            out["grad_norm"] = gn
            out["grad_leaf"] = {k: float(torch.linalg.vector_norm(t))
                                for k, t in clipped.items()}
        del g, clipped
    with torch.no_grad():
        out["change_leaf"] = {k: float(torch.linalg.vector_norm(p[k] - p0[k]))
                              for k in p}
    return out
