"""Plain reference of the benchmark's language models, in PyTorch.

Written from the models' equations as the configuration files state them
(``model`` group), with no kernel, no cache and no batching across rows:
each call takes whole rows and runs every layer on them.  The layers are
the kinds' own (``portbench/layers/<kind>.py``, each found by the name
in the plan, with the MLP an entry names after it, ``portbench/mlps/``)
on the pieces of ``ops``: float32 with TF32 off, or, for the
control, every operand of a product (the projections, attention's two
products, the scans' inputs and the output head) rounded to float8 e4m3
at a scale per tensor.  Every norm is RMSNorm with scale (1 + s).

It imports nothing of the program.  Parameters are a dict of tensors keyed
by the names :func:`param_shapes` gives; the harness draws them from the
seed and hands the same values to the program.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from portbench import layers
from portbench.reference.ops import Params, Precision, pin_float32, rmsnorm

__all__ = ["Params", "Precision", "pin_float32", "plan", "padded_vocab",
           "param_shapes", "routed_layers", "expert_leaves", "logits",
           "loss"]


def plan(m: dict) -> List[str]:
    return list(m.get("prologue", [])) + list(m["superblock"]) * m["n_repeat"]


def padded_vocab(m: dict) -> int:
    """Embedding rows: the vocabulary padded to a multiple of 256."""
    return -(-m["vocab_size"] // 256) * 256


def param_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of every parameter, grouped by the name's first part
    (``embed``, ``final_norm``, ``layers.<i>``, and a shared weight set's
    own)."""
    d = m["d_model"]
    out: Dict[str, Tuple[int, ...]] = {"embed": (padded_vocab(m), d),
                                       "final_norm.scale": (d,)}
    entries = plan(m)
    for i, entry in enumerate(entries):
        pre = f"layers.{i}."
        out[pre + "norm1.scale"] = (d,)
        kind, mlp = layers.split(entry)
        out.update({pre + k: s for k, s in layers.get(kind).params(m).items()})
        if mlp is not None:
            out[pre + "norm2.scale"] = (d,)
            out.update({pre + k: s for k, s in layers.mlp(mlp).params(m).items()})
    for kind in dict.fromkeys(layers.split(e)[0] for e in entries):
        shared = getattr(layers.get(kind), "shared_params", None)
        if shared:
            out.update(shared(m))
    return out


def routed_layers(m: dict) -> List[int]:
    """The plan's layers whose MLP routes tokens to experts."""
    return [i for i, entry in enumerate(plan(m)) if layers.split(entry)[1]
            and hasattr(layers.mlp(layers.split(entry)[1]), "EXPERTS")]


def expert_leaves(m: dict) -> set:
    """The parameters split over processes along their first axis, each
    process holding its share of the experts (``reference.moe.Split``)."""
    return {f"layers.{i}.{k}" for i in routed_layers(m)
            for k in layers.mlp(layers.split(plan(m)[i])[1]).EXPERTS}


def logits(p: Params, tokens, m: dict, prec: Precision, remat=False,
           moe=None):
    """(B, S, vocab) logits of ``tokens`` (B, S) at positions 0..S-1.
    ``remat`` recomputes each layer in the backward (to fit long rows).
    ``moe`` (``reference.moe.Row``): the row's routing through the MoE
    layers, which leave their aux terms there."""
    x = p["embed"][tokens.long()]
    x0 = x
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for i, entry in enumerate(plan(m)):
        kind, mlp = layers.split(entry)
        fwd = layers.get(kind).forward
        if mlp is None:
            def fn(x, i=i, fwd=fwd):
                return fwd(p, i, x, m, prec, x0, positions)
        else:
            def fn(x, i=i, fwd=fwd, mlp=layers.mlp(mlp)):
                pre = f"layers.{i}."
                x = fwd(p, i, x, m, prec, x0, positions)
                h = rmsnorm(x, p[pre + "norm2.scale"], m["norm_eps"])
                return x + mlp.forward(p, pre, h, m, prec, moe, i)
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    x = rmsnorm(x, p["final_norm.scale"], m["norm_eps"])
    return prec.mm(x, p["embed"].T)[..., :m["vocab_size"]]


def loss(p: Params, tokens, labels, m: dict, prec: Precision, remat=True,
         moe=None):
    """Mean next-token cross-entropy over every position; with ``moe``,
    plus the row's part of the MoE layers' aux losses."""
    lg = logits(p, tokens, m, prec, remat=remat, moe=moe)
    ll = lg.gather(-1, labels.long()[..., None])[..., 0] - torch.logsumexp(lg, -1)
    if moe is None:
        return -ll.mean()
    return -ll.mean() + moe.total()
