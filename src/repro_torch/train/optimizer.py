"""Optimizers (port of ``repro/train/optimizer.py``): AdamW, Adafactor and
int8 error-feedback compression, with the reference's numerics.

The reference's pytrees of parameters are dicts of tensors here, keyed by
parameter name (``dict(model.named_parameters())``); optimizer state mirrors
them leaf for leaf.  ``Optimizer(init, update)`` keeps the reference's
shape: ``update(grads, state, params) -> (params, state)``.  Where the
reference returns new parameter arrays, the port writes the new values into
the parameter tensors in place, under ``torch.no_grad()``, and returns the
same dict (one copy of the weights; the model's modules keep pointing at
them).  State tensors are new each step.

The numerics are the reference's, which ``torch.optim.AdamW`` does not
reproduce (its b2 is 0.999 and it has no global-norm clip): the clip comes
before the moments; AdamW adds ``wd * p`` to the step of every leaf and
corrects both moments' bias, with the bias terms computed in float32;
Adafactor factors the second moment of every leaf of 2 or more dims and
clips the update to RMS 1.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

Tree = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state)


def _zeros_like(tree: Tree, dtype=None) -> Tree:
    return {k: torch.zeros(a.shape, dtype=dtype or a.dtype, device=a.device)
            for k, a in tree.items()}


def _step0(params: Tree) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


@torch.no_grad()
def _write(params: Tree, new: Tree) -> Tree:
    for k, p in params.items():
        p.copy_(new[k])
    return params


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, wd: float = 0.01, clip_norm: float = 1.0):
    def init(params):
        return {"m": _zeros_like(params, torch.float32),
                "v": _zeros_like(params, torch.float32),
                "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        grads = _clip_by_global_norm(grads, clip_norm)
        stepf = step.float()
        b1t = 1 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
        b2t = 1 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = b1 * state["m"][k] + (1 - b1) * g
            v = b2 * state["v"][k] + (1 - b2) * torch.square(g)
            mh = m / b1t
            vh = v / b2t
            delta = mh / (torch.sqrt(vh) + eps) + wd * p.float()
            new_p[k] = (p.float() - lr * delta).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return _write(params, new_p), {"m": new_m, "v": new_v, "step": step}

    return Optimizer(init, update)


def adafactor(lr: float = 1e-3, decay: float = 0.99, eps: float = 1e-30,
              clip_norm: float = 1.0, min_dim_factored: int = 2):
    """Factored second moments for >=2D leaves; O(rows+cols) state."""

    def init(params):
        def leaf_state(p):
            if p.dim() >= min_dim_factored:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32, device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
        return {"f": {k: leaf_state(p) for k, p in params.items()},
                "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        grads = _clip_by_global_norm(grads, clip_norm)
        new_p, new_f = {}, {}
        for k, p in params.items():
            fs = state["f"][k]
            g = grads[k].float()
            g2 = torch.square(g) + eps
            if p.dim() >= min_dim_factored:
                vr = decay * fs["vr"] + (1 - decay) * g2.mean(-1)
                vc = decay * fs["vc"] + (1 - decay) * g2.mean(-2)
                denom = (vr[..., :, None] * vc[..., None, :]) / \
                    torch.clamp_min(vr.mean(-1)[..., None, None], eps)
                pre = g * torch.rsqrt(torch.clamp_min(denom, eps))
                new_f[k] = {"vr": vr, "vc": vc}
            else:
                v = decay * fs["v"] + (1 - decay) * g2
                pre = g * torch.rsqrt(torch.clamp_min(v, eps))
                new_f[k] = {"v": v}
            # update clipping (RMS <= 1), Shazeer & Stern
            rms = torch.sqrt(torch.mean(torch.square(pre)) + 1e-12)
            pre = pre / torch.clamp_min(rms, 1.0)
            new_p[k] = (p.float() - lr * pre).to(p.dtype)
        return _write(params, new_p), {"f": new_f, "step": step}

    return Optimizer(init, update)


def ef_compress(base: Optimizer, bits: int = 8):
    """Int8 error-feedback gradient compression wrapper: gradients are
    quantized (per-leaf absmax scale) before the optimizer and the
    quantization residual is carried to the next step."""
    qmax = float(2 ** (bits - 1) - 1)

    def init(params):
        return {"base": base.init(params),
                "ef": _zeros_like(params, torch.float32)}

    @torch.no_grad()
    def update(grads, state, params):
        qgrads, ef = {}, {}
        for k, g in grads.items():
            g = g.float() + state["ef"][k]
            scale = torch.clamp_min(g.abs().max(), 1e-12) / qmax
            qg = torch.round(g / scale).clamp(-qmax, qmax) * scale
            qgrads[k], ef[k] = qg, g - qg
        new_p, new_base = base.update(qgrads, state["base"], params)
        return new_p, {"base": new_base, "ef": ef}

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float = 1e-3, compress: bool = False,
                   **kw) -> Optimizer:
    opt = adafactor(lr=lr, **kw) if name == "adafactor" else adamw(lr=lr, **kw)
    return ef_compress(opt) if compress else opt


def _clip_by_global_norm(grads: Tree, max_norm) -> Tree:
    if max_norm is None:
        return grads
    sq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
    norm = torch.sqrt(sq)
    factor = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return {k: (g.float() * factor).to(g.dtype) for k, g in grads.items()}
