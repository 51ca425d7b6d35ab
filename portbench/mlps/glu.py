"""A SiLU-gated MLP of ``d_ff``: (SiLU(h Wg) * (h Wi)) Wo."""
from __future__ import annotations

import torch.nn.functional as F


def params(m):
    d, f = m["d_model"], m["d_ff"]
    return {"mlp.wi": (d, f), "mlp.wg": (d, f), "mlp.wo": (f, d)}


def forward(p, pre, h, m, prec, moe=None, i=None):
    g = lambda name: p[pre + name]  # noqa: E731
    return prec.mm(F.silu(prec.mm(h, g("mlp.wg"))) * prec.mm(h, g("mlp.wi")),
                   g("mlp.wo"))


def products(m) -> float:
    return 3 * m["d_model"] * m["d_ff"]
