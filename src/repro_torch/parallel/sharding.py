"""Logical-axis sharding rules (port of ``repro/parallel/sharding.py``).

Tensors are annotated with *logical* axis names; a rule table maps those to
physical mesh axes.  Mapping is divisibility-aware: a logical axis whose
dimension does not divide by the physical axis size falls back to
replication (phi4's 24 heads, whisper's 6 heads and granite's 49155-vocab
on a 16-way ``model`` axis).

:func:`spec_for` and :func:`param_spec` give the reference's
``PartitionSpec`` as the port's own :class:`PartitionSpec`, a tuple with,
for each tensor dim, None, one mesh-axis name or a tuple of them; they read
only ``mesh.shape`` as a dict of axis name to size (a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``, or a
stub with such a dict).  :func:`placements` turns a spec into DTensor
placements.  The two say opposite things: a spec names, for each tensor
dim, the mesh axes that split it; a placement names, for each mesh dim, the
tensor dim it splits.  A tensor dim over several mesh axes
(``("pod", "data")``) is ``Shard(d)`` on each of them; DTensor splits in
mesh-dim order, so the spec's axes must come in the mesh's order, which is
also the block order JAX gives them (block = outer index x inner size +
inner index).

:func:`activation_rules` is a thread-local context; :func:`constrain` is
the identity outside it (single-device code runs the same path) and, with
a mesh, redistributes a DTensor to the spec's placements.

DTensor hand-offs (``on_local_shards``): the CUDA kernels take a plain
contiguous tensor and its ``data_ptr``, and some ops mix a DTensor with a
plain tensor made inside the model (RoPE's angles).  Those run through
``torch.distributed.tensor.experimental.local_map`` on each rank's local
shard, the batch rows it owns: attention and the scans are local per batch
row, so nothing moves but what a reshard to batch placements needs.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

_TLS = threading.local()

# default logical -> physical axis mapping (production mesh)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tensor": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "mlp": ("model",),
    "kv_seq": ("model",),
    "seq": (),
    "dp_only": ("pod", "data", "model"),  # whisper-style pure-DP batch
}


class PartitionSpec(tuple):
    """For each tensor dim: None, a mesh-axis name, or a tuple of them."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, from a DeviceMesh or a stub whose ``shape`` is
    that dict already."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return shape
    return dict(zip(mesh.mesh_dim_names, shape))


class ShardCtx:
    def __init__(self, mesh, rules: Dict[str, Tuple[str, ...]]):
        self.mesh = mesh
        self.rules = rules


def current() -> Optional[ShardCtx]:
    return getattr(_TLS, "ctx", None)


def _resolve(mesh, rules: Optional[Dict]) -> Dict[str, Tuple[str, ...]]:
    r = dict(DEFAULT_RULES)
    if rules:
        r.update(rules)
    # drop mesh axes that don't exist (single-pod mesh has no "pod")
    shape = mesh_shape(mesh)
    return {k: tuple(a for a in v if a in shape) for k, v in r.items()}


@contextlib.contextmanager
def activation_rules(mesh, rules: Optional[Dict] = None):
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = None if mesh is None else ShardCtx(mesh, _resolve(mesh, rules))
    try:
        yield
    finally:
        _TLS.ctx = prev


def _fit_axes(dim: int, phys: Tuple[str, ...], mesh) -> Tuple[str, ...]:
    """Largest prefix of `phys` whose product divides `dim`."""
    shape = mesh_shape(mesh)
    out = []
    size = 1
    for a in phys:
        s = shape[a]
        if dim % (size * s) == 0:
            out.append(a)
            size *= s
        else:
            break
    return tuple(out)


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             mesh, rules: Dict[str, Tuple[str, ...]]) -> PartitionSpec:
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, "
                         f"logical axes {tuple(logical)} {len(logical)}")
    axes = mesh_shape(mesh)
    parts = []
    used = set()
    for dim, name in zip(shape, logical):
        if name is None:
            parts.append(None)
            continue
        phys = tuple(a for a in rules.get(name, ()) if a in axes and a not in used)
        phys = _fit_axes(dim, phys, mesh)
        used.update(phys)
        parts.append(phys if len(phys) != 1 else phys[0])
        if not phys:
            parts[-1] = None
    return PartitionSpec(*parts)


def placements(spec: Sequence, mesh) -> Tuple:
    """The DTensor placements of ``spec`` on the DeviceMesh ``mesh``: for
    each mesh dim, ``Shard(d)`` for the tensor dim d whose part names that
    axis, else ``Replicate()``."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: dim {d} splits over "
                             f"{axes}, not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def batch_placements(x: DTensor) -> Tuple:
    """``x``'s placements with everything but a split of dim 0 replicated:
    the placements under which each rank holds whole batch rows."""
    return tuple(p if p == Shard(0) else Replicate() for p in x.placements)


def on_local_shards(fn, *args):
    """``fn(*args)`` where no DTensor is among ``args``; else ``fn`` on each
    DTensor's local shard, every DTensor first resharded to its
    :func:`batch_placements` (a parameter enters replicated), the output
    taking the first DTensor's, which holds the batch.  Differentiable:
    a gradient leaves in its input's placements, except that a replicated
    input (a parameter) read by batch rows split over a mesh dim gets its
    gradient as a partial sum over that dim."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    rows = batch_placements(dts[0])

    def grad_place(a):
        return [Partial() if p == Replicate() and r == Shard(0) else p
                for p, r in zip(batch_placements(a), rows)]
    # a list is one output's placements (a tuple would be one an output)
    in_place = tuple(list(batch_placements(a)) if isinstance(a, DTensor)
                     else None for a in args)
    in_grad = tuple(grad_place(a) if isinstance(a, DTensor) else None
                    for a in args)
    return local_map(fn, out_placements=list(rows), in_placements=in_place,
                     in_grad_placements=in_grad,
                     device_mesh=dts[0].device_mesh,
                     redistribute_inputs=True)(*args)


class _Apply(nn.Module):
    """``fn(module, *args)`` as a forward, so that
    ``torch.func.functional_call`` can stand other tensors in for
    ``module``'s parameters."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.m = module

    def forward(self, fn, *args):
        return fn(self.m, *args)


def with_whole_params(module: nn.Module, fn, *args):
    """``fn(module, *args)`` with ``module``'s DTensor parameters read
    whole: each redistributed to ``Replicate()`` here (a differentiable
    all-gather of a split weight, whose gradient goes back to the
    parameter's placements) and dropped when ``fn`` returns.  Called
    inside a remat region, the recompute gathers again, so that one
    layer's weights are whole at a time.  With plain parameters it is
    ``fn(module, *args)``.  It reads the parameters, never the
    thread-local rules: on the card a recompute runs on autograd's device
    thread, where ``activation_rules`` is not set."""
    whole = {f"m.{k}": p.redistribute(p.device_mesh,
                                      [Replicate()] * p.device_mesh.ndim)
             for k, p in module.named_parameters() if isinstance(p, DTensor)}
    if not whole:
        return fn(module, *args)
    return torch.func.functional_call(_Apply(module), whole, (fn,) + args)


def constrain(x, *logical: Optional[str]):
    """Apply a logical sharding constraint if a mesh context is active: the
    DTensor ``x`` redistributed to the spec's placements."""
    ctx = current()
    if ctx is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain under a mesh takes a DTensor, not "
                        f"{type(x).__name__}")
    spec = spec_for(x.shape, logical, ctx.mesh, ctx.rules)
    return x.redistribute(ctx.mesh, placements(spec, ctx.mesh))


# ---------------------------------------------------------------------------
# Parameter sharding by leaf path
# ---------------------------------------------------------------------------

# last-path-component -> logical axes by rank (applied right-aligned)
_PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # vocab-sharded only: fsdp-sharding the d_model dim makes GSPMD fully
    # rematerialize the token gather (measured: +18 GB temp on multi-pod);
    # worst case replicated-dim cost is 295 MB/chip (gemma2)
    "embed": ("vocab", None),
    "lm_head": ("fsdp", "vocab"),
    "pos_embed": (None, "fsdp"),
    # (in, out)-shaped projections
    "wq": ("fsdp", "tensor"), "wk": ("fsdp", "tensor"), "wv": ("fsdp", "tensor"),
    "wi": ("fsdp", "tensor"), "wg": ("fsdp", "tensor"), "wr": ("fsdp", "tensor"),
    "wkv_a": ("fsdp", "tensor"), "wk_rope": ("fsdp", None),
    "wk_b": ("fsdp", "tensor"), "wv_b": ("fsdp", "tensor"),
    "w_in": ("fsdp", "tensor"), "ck": ("fsdp", "tensor"),
    "cr": ("fsdp", "tensor"), "w_router": ("fsdp", None),
    "w_lora_a": ("fsdp", None), "wg_gate": ("fsdp", "tensor"),
    "w_img": ("fsdp", "tensor"),
    # (out, in)-shaped projections
    "wo": ("tensor", "fsdp"), "cv": ("tensor", "fsdp"),
    "w_out": ("tensor", "fsdp"), "w_lora_b": (None, "fsdp"),
    # experts
    "experts_wi": ("experts", "fsdp", None),
    "experts_wg": ("experts", "fsdp", None),
    "experts_wo": ("experts", None, "fsdp"),
    # conv / small
    "conv_w": (None, "tensor"),
    "u": (None, None),
}


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
               rules: Dict[str, Tuple[str, ...]]) -> PartitionSpec:
    name = path[-1]
    logical = _PARAM_RULES.get(name)
    if logical is None:
        logical = (None,) * len(shape)  # norms, scalars, biases: replicate
    # scanned stacks have a leading layer dim
    extra = len(shape) - len(logical)
    if extra > 0:
        logical = (None,) * extra + tuple(logical)
    elif extra < 0:
        logical = logical[-len(shape):] if len(shape) else ()
    return spec_for(shape, logical, mesh, rules)


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec

    def placements(self) -> Tuple:
        return placements(self.spec, self.mesh)


def param_spec_tree(params, mesh, rules: Optional[Dict] = None
                    ) -> Dict[str, NamedSharding]:
    """{parameter name: NamedSharding} over ``params`` (a module, by
    ``named_parameters()``, or a dict of tensors by name).  The path of
    ``layers.3.attn.wq`` is its dotted name, and its rule is the last
    component's, as the reference reads its leaf paths."""
    r = _resolve(mesh, rules)
    named = (params.named_parameters() if hasattr(params, "named_parameters")
             else params.items())
    return {name: NamedSharding(mesh, param_spec(tuple(name.split(".")),
                                                 tuple(p.shape), mesh, r))
            for name, p in named}
