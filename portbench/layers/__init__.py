"""The layer kinds of the benchmark's models, one module each, found by
the kind's name in a configuration's plan: ``portbench/layers/<kind>.py``.

A kind's module holds all that the harness knows of it:

  params(m)          {name under ``layers.<i>.``: shape}, after the
                     ``norm1.scale`` every layer has
  shared_params(m)   (where the kind shares one weight set between its
                     applications) {full name: shape}
  forward(p, i, x, m, prec, x0, positions)
                     the plain reference of the layer
  products(m)        weights a token multiplies by in one application
  mixer_flops(m, seq_len, train, kv_len)
                     attention's or a scan's FLOPs a token
  KERNEL             the port's hand-written kernel that runs it, or None

A model of a new kind is a new module here and a configuration file;
nothing else names a kind.
"""
from __future__ import annotations

import functools
import importlib
import pkgutil
from dataclasses import dataclass
from typing import Callable, Dict, Tuple


@dataclass(frozen=True)
class Kernel:
    """A hand-written kernel of the port, as the harness sees it.

    ``name``: its wrapper ``repro_torch.kernels.<name>``, whose counters
    ``launches`` and ``bwd_launches`` the harness reads.  ``own``: the
    fragments of its device kernels' names; ``shared``: those of kernels
    another hand-written kernel also launches (counted with the one whose
    own kernels ran).  ``launch_shape(m, rows, seq_len)``: the keywords of
    ``fwd_bound`` and ``bwd_bound``, the least seconds of a forward launch
    and a backward call (``work.bound_s``)."""
    name: str
    own: Tuple[str, ...]
    shared: Tuple[str, ...]
    launch_shape: Callable[..., Dict[str, int]]
    fwd_bound: Callable[..., float]
    bwd_bound: Callable[..., float]

    @property
    def module(self) -> str:
        return f"repro_torch.kernels.{self.name}"


def get(kind: str):
    """The module of a layer kind."""
    return importlib.import_module(f"{__name__}.{kind}")


@functools.lru_cache(maxsize=None)
def kernels() -> Tuple[Kernel, ...]:
    """Every kind's hand-written kernel (the trace's reduction asks for
    each device event)."""
    mods = (get(info.name) for info in pkgutil.iter_modules(__path__))
    return tuple(m.KERNEL for m in mods if m.KERNEL is not None)


def kernel(name: str) -> Kernel:
    return {k.name: k for k in kernels()}[name]
