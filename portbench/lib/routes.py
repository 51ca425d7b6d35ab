"""The program's expert choices, recorded while its checked steps run.

The port's router is ``repro_torch.models.moe._route`` (``(p, xf, cfg,
*n_tokens) -> (expert ids (G, T, k), gates, aux)``), called once a MoE
layer and microbatch in the forward and once more in a remat recompute.
:func:`recorded` wraps it, as ``chip_smoke.py``'s ``_routes`` does,
and keeps every call's ids; the window never runs under it.  The
reference then takes the program's choices: a top-k that rounding flips
for a near-tied token would otherwise put whole tokens between two sound
runs.  The wrapped function is a coupling with the program: a change
that renames it must keep a function of its role.
"""
from __future__ import annotations

import contextlib
from typing import List

import torch


@contextlib.contextmanager
def recorded(calls: List[torch.Tensor]):
    """Append each router call's expert ids (uint8, on its device) to
    ``calls`` while the block runs."""
    from repro_torch.models import moe
    real = moe._route

    def route(p, xf, cfg, *rest):
        ids, gates, aux = real(p, xf, cfg, *rest)
        calls.append(ids.to(torch.uint8))
        return ids, gates, aux
    moe._route = route
    try:
        yield calls
    finally:
        moe._route = real


def by_microbatch(calls: List[torch.Tensor], microbatches: int, layers: int,
                  recomputed: int):
    """[microbatch][layer] ids of one step's calls, and how many ids the
    remat recompute chose otherwise than the forward.  A microbatch's
    calls are its ``layers`` MoE layers' forwards in order, then
    ``recomputed`` of them again in reverse (the backward's recompute of
    the last ``recomputed``)."""
    per = layers + recomputed
    if len(calls) != microbatches * per:
        raise ValueError(f"{len(calls)} router calls in a step, not "
                         f"{microbatches} microbatches x {per}")
    out, differ = [], 0
    for mb in range(microbatches):
        c = calls[mb * per:(mb + 1) * per]
        out.append(c[:layers])
        again = c[layers:][::-1]
        differ += sum(int((a != b).sum())
                      for a, b in zip(c[layers - recomputed:layers], again))
    return out, differ
