"""Plain training steps for the reference: the mean cross-entropy of a
batch (with a MoE model's aux losses), its gradients summed row by row,
and AdamW with a clip on the global norm (the clip before the moments,
both moments bias-corrected, ``wd * p`` added to every leaf's step).

``follow`` runs the steps from given parameters and batches and returns
what the benchmark compares: each step's loss, the first step's gradient
norm before the clip, each leaf's norm of the first gradient after it (as
the optimizer gets it), and each leaf's change over the steps.  Where
processes share the experts (``reference.moe.Split``), each holds and
updates its share of the expert leaves and everything else whole; those
leaves' norms are summed over the processes, so that every process
returns the same numbers.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from portbench.reference import lm
from portbench.reference import moe as ref_moe


def grads(p: lm.Params, tokens, labels, m: dict, prec: lm.Precision,
          rows=None, moe: Optional[ref_moe.Routing] = None):
    """(loss, {name: gradient}) of the batch's mean loss, one row at a
    time.  ``rows`` (a slice) keeps part of the batch: the mean is then
    over those rows (a fault the harness's tests plant).  ``moe``: the
    step's routing through the MoE layers."""
    full = tokens.shape[0]
    index = range(full)
    if rows is not None:
        tokens, labels, index = tokens[rows], labels[rows], index[rows]
    n = tokens.shape[0]
    for t in p.values():
        t.grad = None
    total = 0.0
    for b in range(n):
        row = None if moe is None else moe.row(index[b], full)
        loss = lm.loss(p, tokens[b:b + 1], labels[b:b + 1], m, prec,
                       moe=row) / n
        loss.backward()
        total += float(loss.detach())
    return total, {k: (t.grad if t.grad is not None else torch.zeros_like(t))
                   for k, t in p.items()}


def own_routes(p: lm.Params, tokens, m: dict, prec: lm.Precision,
               moe: ref_moe.Routing) -> List[List[torch.Tensor]]:
    """A step's routes from the reference's own top-k: a first pass
    without gradients, row by row."""
    rows = tokens.shape[0]
    taken = []
    with torch.no_grad():
        for b in range(rows):
            row = moe.row(b, rows, record=True)
            lm.logits(p, tokens[b:b + 1], m, prec, moe=row)
            taken.append(row)
    return moe.assemble(taken)


def _norm(t, split: Optional[ref_moe.Split]) -> float:
    """A leaf's norm; over every process's share where ``split`` is
    given."""
    n = float(torch.linalg.vector_norm(t))
    return n if split is None else math.sqrt(split.total(n * n))


@torch.no_grad()
def adamw(p: lm.Params, g: Dict[str, torch.Tensor], st: dict, o: dict,
          norms: bool = False, split: Optional[ref_moe.Split] = None,
          experts=frozenset()):
    """One update in place; returns the global gradient norm before the
    clip and, with ``norms``, each leaf's norm of its clipped gradient.
    ``experts``: the leaves that ``split`` shares out."""
    st["step"] += 1
    if not experts:
        gn = torch.sqrt(sum(torch.sum(x.square()) for x in g.values()))
    else:
        whole = float(sum(torch.sum(x.square()) for k, x in g.items()
                          if k not in experts))
        shared = float(sum(torch.sum(g[k].square()) for k in experts))
        gn = torch.tensor(math.sqrt(whole + split.total(shared)),
                          device=next(iter(g.values())).device)
    factor = torch.clamp_max(o["clip_norm"] / torch.clamp_min(gn, 1e-12), 1.0)
    b1t = 1 - o["b1"] ** st["step"]
    b2t = 1 - o["b2"] ** st["step"]
    leaf = {}
    for k, t in p.items():
        gk = g[k] * factor
        if norms:
            leaf[k] = _norm(gk, split if k in experts else None)
        m = st["m"].setdefault(k, torch.zeros_like(t))
        v = st["v"].setdefault(k, torch.zeros_like(t))
        m.mul_(o["b1"]).add_((1 - o["b1"]) * gk)
        v.mul_(o["b2"]).add_((1 - o["b2"]) * gk.square())
        t.sub_(o["lr"] * ((m / b1t) / (torch.sqrt(v / b2t) + o["eps"])
                          + o["wd"] * t))
        del gk
    return float(gn), leaf


def follow(p0: lm.Params, batches: List[dict], m: dict, o: dict,
           prec: lm.Precision, rows=None,
           moe: Optional[ref_moe.Routing] = None) -> dict:
    """Train a copy of ``p0`` over ``batches`` ({"tokens", "labels"}).
    Returns {"loss": [..], "grad_norm": float, "grad_leaf": {name:
    norm}, "change_leaf": {name: norm}}, and with ``moe`` its routing's
    ``stats`` under "moe".  ``p0`` holds this process's share of the
    expert leaves where ``moe.split`` shares them."""
    p = {k: t.detach().clone().requires_grad_(True) for k, t in p0.items()}
    st = {"step": 0, "m": {}, "v": {}}
    out = {"loss": []}
    split = moe.split if moe is not None and moe.split.world > 1 else None
    experts = frozenset(lm.expert_leaves(m)) if split is not None \
        else frozenset()
    for i, b in enumerate(batches):
        if moe is not None:
            moe.use(i, moe.routes[i] if moe.routes is not None
                    else own_routes(p, b["tokens"], m, prec, moe))
        loss, g = grads(p, b["tokens"], b["labels"], m, prec, rows, moe)
        out["loss"].append(loss)
        gn, leaf = adamw(p, g, st, o, norms=i == 0, split=split,
                         experts=experts)
        if i == 0:
            out["grad_norm"] = gn
            out["grad_leaf"] = leaf
        del g
    with torch.no_grad():
        out["change_leaf"] = {k: _norm(p[k] - p0[k],
                                       split if k in experts else None)
                              for k in p}
    if moe is not None:
        out["moe"] = moe.stats
    return out
