"""The layer kinds of the benchmark's models, one module each, found by
the kind's name in a configuration's plan: ``portbench/layers/<kind>.py``.
A plan's entry is ``<kind>``, a module that is the whole layer, or
``<kind>+<mlp>``: the kind's module is then the layer's mixer with its
residual, and ``portbench/mlps/<mlp>.py`` the MLP after it, over the
layer's ``norm2`` (``mla+glu`` and ``mla+moe`` share a mixer and differ in
their MLP).

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
  STATE              True where the reference carries a state from one
                     chunk to the next (``Precision(carry=False)`` drops it)

An MLP's module holds ``params(m)`` (under ``layers.<i>.mlp.``),
``forward(p, pre, h, m, prec, moe, i)`` and ``products(m)``.  Several
kinds may run one hand-written kernel, each at its own launch shape and
with its own bounds: each declares a ``Kernel`` of the same name and the
same device-kernel fragments.

A model of a new kind is a new module here and a configuration file;
nothing else names a kind.
"""
from __future__ import annotations

import functools
import importlib
import pkgutil
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple


@dataclass(frozen=True)
class Kernel:
    """A hand-written kernel of the port, as the harness sees it.

    ``name``: its wrapper ``repro_torch.kernels.<name>``, whose counters
    ``launches`` and ``bwd_launches`` the harness reads.  ``own``: the
    fragments of its device kernels' names; ``shared``: those of kernels
    another hand-written kernel also launches (counted with the one whose
    own kernels ran).  ``launch_shape(m, rows, seq_len, tp=1)``: the
    keywords of ``fwd_bound`` and ``bwd_bound``, the least seconds of a
    forward launch and a backward call (``work.bound_s``), for ``rows``
    rows a launch with the heads split ``tp`` ways (tensor parallelism)."""
    name: str
    own: Tuple[str, ...]
    shared: Tuple[str, ...]
    launch_shape: Callable[..., Dict[str, int]]
    fwd_bound: Callable[..., float]
    bwd_bound: Callable[..., float]

    @property
    def module(self) -> str:
        return f"repro_torch.kernels.{self.name}"


def split(entry: str) -> Tuple[str, Optional[str]]:
    """(kind, MLP or None) of a plan's entry."""
    kind, _, mlp = entry.partition("+")
    return kind, mlp or None


def get(kind: str):
    """The module of a layer kind."""
    return importlib.import_module(f"{__name__}.{kind}")


def mlp(name: str):
    """The module of an MLP."""
    return importlib.import_module(f"portbench.mlps.{name}")


def parts(entry: str):
    """The modules of a plan's entry: its kind's, then its MLP's."""
    kind, name = split(entry)
    return (get(kind),) if name is None else (get(kind), mlp(name))


@functools.lru_cache(maxsize=None)
def _kinds() -> Dict[str, Kernel]:
    """{kind: its hand-written kernel} of every kind that has one."""
    mods = {info.name: get(info.name) for info in pkgutil.iter_modules(__path__)}
    return {kind: m.KERNEL for kind, m in mods.items() if m.KERNEL is not None}


@functools.lru_cache(maxsize=None)
def kernels() -> Tuple[Kernel, ...]:
    """Every hand-written kernel, once (the trace's reduction asks for each
    device event); the kinds that share one declare the same fragments."""
    out: Dict[str, Kernel] = {}
    for k in _kinds().values():
        first = out.setdefault(k.name, k)
        if (first.own, first.shared) != (k.own, k.shared):
            raise ValueError(f"kinds declare {k.name} with other fragments")
    return tuple(out.values())


def kernel_kinds(name: str) -> Dict[str, Kernel]:
    """{kind: its declaration} of every kind that runs kernel ``name``."""
    return {kind: k for kind, k in _kinds().items() if k.name == name}
