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

Stacked leaves.  The reference holds each superblock position's layers
stacked over ``n_repeat`` (and whisper's encoder layers over
``n_enc_layers``); the port keeps one parameter a layer.  AdamW is
elementwise and its clip reads the global norm, which does not depend on
the grouping, so it runs on the per-layer leaves as they are.  Adafactor
does depend on it: it factors the second moment of an (L, d) norm scale
into (L,) + (d,) and takes the update's RMS over the whole stacked leaf.
So, given the model's ``layout`` (``make_optimizer(..., cfg=cfg)``), it
stacks the per-layer gradients of each reference leaf (``stacked_groups``:
``blocks.{i}.{leaf}`` over the repeats, ``encoder.blocks.{leaf}`` over the
encoder layers), updates the stacked leaf as the reference does, and writes
each row back to its layer's parameter.  Its state is keyed by those
stacked names (and by the parameter's own name for the leaves the
reference does not stack), with the reference's shapes.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

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
    # elementwise, and the clip reads the global norm: the per-layer
    # leaves give the reference's stacked update as they are
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


def stacked_groups(names: List[str], layout: Optional[Tuple[int, int]]
                   ) -> Dict[str, List[str]]:
    """{leaf of the reference's tree: the port's parameter names that are
    its rows, in order}.  ``layout`` is (prologue layers, superblock
    length): layer ``n_pro + r n_sb + i`` is row r of ``blocks.{i}``, and
    encoder layer r row r of ``encoder.blocks``.  Every other parameter
    (and every one when ``layout`` is None) is a leaf of its own, under its
    own name."""
    groups: Dict[str, Dict[int, str]] = {}
    for name in names:
        key, row = name, None
        found = re.fullmatch(r"layers\.(\d+)\.(.+)", name)
        if layout is not None and found and int(found.group(1)) >= layout[0]:
            j = int(found.group(1)) - layout[0]
            key, row = f"blocks.{j % layout[1]}.{found.group(2)}", \
                j // layout[1]
        found = re.fullmatch(r"encoder\.blocks\.(\d+)\.(.+)", name)
        if layout is not None and found:
            key, row = f"encoder.blocks.{found.group(2)}", int(found.group(1))
        groups.setdefault(key, {})[row] = name
    return {k: [rows[r] for r in sorted(rows, key=lambda r: r or 0)]
            for k, rows in groups.items()}


def adafactor(lr: float = 1e-3, decay: float = 0.99, eps: float = 1e-30,
              clip_norm: float = 1.0, min_dim_factored: int = 2,
              layout: Optional[Tuple[int, int]] = None):
    """Factored second moments for >=2D leaves; O(rows+cols) state.
    ``layout`` (prologue layers, superblock length) stacks the per-layer
    leaves as the reference's tree holds them (see the module's notes);
    None treats every parameter as a leaf.  Where a layer's leaf has 2 or
    more dims, the stacked leaf's moments are row by row (its rows, the
    layers, meet only in the update clip's RMS), so its gradients are
    never stacked: only the small factored moments are."""

    def leaves(tree: Tree) -> Dict[str, Tuple[List[str], bool]]:
        return {k: (names, k not in tree)
                for k, names in stacked_groups(list(tree), layout).items()}

    def moments(g, fs):
        """(preconditioned update, new moments) of one leaf ``g``."""
        g2 = torch.square(g) + eps
        if g.dim() >= min_dim_factored:
            vr = decay * fs["vr"] + (1 - decay) * g2.mean(-1)
            vc = decay * fs["vc"] + (1 - decay) * g2.mean(-2)
            denom = (vr[..., :, None] * vc[..., None, :]) / \
                torch.clamp_min(vr.mean(-1)[..., None, None], eps)
            return (g * torch.rsqrt(torch.clamp_min(denom, eps)),
                    {"vr": vr, "vc": vc})
        v = decay * fs["v"] + (1 - decay) * g2
        return g * torch.rsqrt(torch.clamp_min(v, eps)), {"v": v}

    def init(params):
        def leaf_state(shape, device):
            if len(shape) >= min_dim_factored:
                return {"vr": torch.zeros(shape[:-1], dtype=torch.float32,
                                          device=device),
                        "vc": torch.zeros(shape[:-2] + shape[-1:],
                                          dtype=torch.float32, device=device)}
            return {"v": torch.zeros(shape, dtype=torch.float32,
                                     device=device)}
        f = {}
        for k, (names, stacked) in leaves(params).items():
            p = params[names[0]]
            shape = ((len(names),) if stacked else ()) + tuple(p.shape)
            f[k] = leaf_state(torch.Size(shape), p.device)
        return {"f": f, "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        grads = _clip_by_global_norm(grads, clip_norm)
        new_p, new_f = {}, {}
        for k, (names, stacked) in leaves(params).items():
            fs = state["f"][k]
            if stacked and params[names[0]].dim() >= min_dim_factored:
                rows = [moments(grads[n].float(), {m: t[r] for m, t in
                                                   fs.items()})
                        for r, n in enumerate(names)]
                pres = [pre for pre, _ in rows]
                new_f[k] = {m: _placed_like(torch.stack(
                    [row[m] for _, row in rows]), t) for m, t in fs.items()}
            elif stacked:
                pre, new_f[k] = moments(torch.stack(
                    [grads[n].float() for n in names]), fs)
                pres = list(pre)
            else:
                pre, new_f[k] = moments(grads[k].float(), fs)
                pres = [pre]
            # update clipping (RMS <= 1) over the reference's leaf, Shazeer
            # & Stern
            sq = sum(torch.sum(torch.square(pre)) for pre in pres)
            rms = torch.sqrt(sq / sum(pre.numel() for pre in pres) + 1e-12)
            for n, pre in zip(names, pres):
                p = params[n]
                new_p[n] = (p.float() - lr * (pre / torch.clamp_min(rms, 1.0))
                            ).to(p.dtype)
        return _write(params, new_p), {"f": new_f, "step": step}

    return Optimizer(init, update)


def _placed_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` in ``ref``'s placements where both are DTensors (a moment
    stacked from row-wise results keeps the state's placement)."""
    if isinstance(t, DTensor) and isinstance(ref, DTensor) \
            and t.placements != ref.placements:
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


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


def layout_of(cfg) -> Tuple[int, int]:
    """(prologue layers, superblock length) of a model config."""
    return len(cfg.prologue), len(cfg.superblock)


def make_optimizer(name: str, lr: float = 1e-3, compress: bool = False,
                   cfg=None, **kw) -> Optimizer:
    """``cfg``: the model's config, whose layout Adafactor stacks its
    leaves by; required for Adafactor (without it every layer would be a
    leaf of its own, a different optimizer from the reference's), unused
    by AdamW."""
    if name == "adafactor":
        if cfg is None:
            raise ValueError("adafactor stacks the layers' leaves by the "
                             "model's layout: pass cfg")
        opt = adafactor(lr=lr, layout=layout_of(cfg), **kw)
    else:
        opt = adamw(lr=lr, **kw)
    return ef_compress(opt) if compress else opt


def _clip_by_global_norm(grads: Tree, max_norm) -> Tree:
    if max_norm is None:
        return grads
    sq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
    norm = torch.sqrt(sq)
    factor = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return {k: (g.float() * factor).to(g.dtype) for k, g in grads.items()}
