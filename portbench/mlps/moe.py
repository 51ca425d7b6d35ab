"""A mixture of experts beside shared experts (DeepSeek-V2's): a softmax
router over ``n_experts``; each token's ``top_k`` experts (ties to the
lower index) with their probabilities renormalised as gates; groups of
``moe_group`` tokens, each expert taking at most its capacity of a
group's slots (``reference/moe.py``); each expert a SiLU-gated MLP of
``d_ff_expert``; and ``n_shared_experts`` experts every token takes,
one SiLU-gated MLP of their summed width.  The aux losses are the
load-balance term E sum_e me_e ce_e (``me``: the microbatch's mean router
probability of expert e, ``ce``: its share of first choices) and the
router's z-loss, the mean squared log-sum-exp of its logits, weighted by
``moe_lb_coef`` and ``moe_z_coef`` and summed over the layers.

A process holds its share of the experts (``reference.moe.Split``):
``EXPERTS`` are the leaves split along their first axis."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import moe as ref_moe

EXPERTS = ("mlp.experts_wi", "mlp.experts_wg", "mlp.experts_wo")


def params(m):
    d, E, f = m["d_model"], m["n_experts"], m["d_ff_expert"]
    fs = m["n_shared_experts"] * f
    return {"mlp.w_router": (d, E), "mlp.experts_wi": (E, d, f),
            "mlp.experts_wg": (E, d, f), "mlp.experts_wo": (E, f, d),
            "mlp.shared.wi": (d, fs), "mlp.shared.wg": (d, fs),
            "mlp.shared.wo": (fs, d)}


def _glu(x, wi, wg, wo, prec):
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wi), wo)


def forward(p, pre, h, m, prec, moe, i):
    """h (1, S, d) -> the layer's MLP output; ``moe`` (``reference.moe.Row``)
    gives the row's experts and takes its aux terms."""
    g = lambda name: p[pre + name]  # noqa: E731
    Bb, S, d = h.shape
    E = m["n_experts"]
    T = moe.group(S)
    x = h.reshape(-1, T, d)
    logits = prec.mm(x, g("mlp.w_router"))
    probs = torch.softmax(logits, -1)
    ids = moe.ids(i, probs)
    gate = probs.gather(-1, ids)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = ref_moe.positions(ids, E) < ref_moe.capacity(m, T)
    split = moe.book.split
    xs, gs = split.enter(x), split.enter(gate * keep)
    e0, n = split.experts(E)
    # one expert's matrices as views of the stacks: unbind's gradient is
    # one stack of the experts' gradients, where indexing would add a
    # zero stack for each expert
    wi, wg, wo = (g(name).unbind(0) for name in EXPERTS)
    y = torch.zeros_like(x)
    for e in range(n):
        gi, ti, si = torch.nonzero((ids == e0 + e) & keep, as_tuple=True)
        if len(gi):
            ye = _glu(xs[gi, ti], wi[e], wg[e], wo[e], prec)
            y = y.index_put((gi, ti), ye * gs[gi, ti, si][:, None],
                            accumulate=True)
    y = split.combine(y) + _glu(x, g("mlp.shared.wi"), g("mlp.shared.wg"),
                                g("mlp.shared.wo"), prec)
    if not moe.record:
        moe.count(i, probs, ids, keep)
        lb = E * (moe.ce(i).to(probs.device) * probs.reshape(-1, E).mean(0)).sum()
        moe.add(i, lb, torch.logsumexp(logits, -1).square().mean())
    return y.reshape(Bb, S, d)


def products(m) -> float:
    d, f = m["d_model"], m["d_ff_expert"]
    return d * m["n_experts"] + 3 * d * f * (m["top_k"] + m["n_shared_experts"])
