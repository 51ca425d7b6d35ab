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

Tensor parallelism (the reference's rule: weights are never gathered over
``model``; activations are resharded where the next op cannot run on the
split).  A parameter is read in :func:`compute_placements` (gathered over
the fsdp dims, its split over ``TP_AXIS`` kept; :func:`gathered`,
:func:`with_gathered_params`), and :func:`linear` runs the product
column- or row-parallel from the weight's placements.  Heads come out of a
column-parallel projection split over ``model`` (:func:`unflatten_heads`,
gathered first where they do not divide it).

DTensor hand-offs (:func:`run_local`, :func:`on_local_shards`): the CUDA
kernels take a plain contiguous tensor and its ``data_ptr``, and some ops
mix a DTensor with a plain tensor made inside the model (RoPE's angles).
Those run through ``torch.distributed.tensor.experimental.local_map`` on
each rank's local shard: the batch rows it owns and, where kept, its
heads.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
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
    axis, else ``Replicate()``.  A mesh dim of size 1 splits nothing and
    stays ``Replicate()`` (DTensor cannot flatten a dim of size 1 split
    over it)."""
    names = tuple(mesh.mesh_dim_names)
    size = mesh_shape(mesh)
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
            if size[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def batch_placements(x: DTensor, keep: Optional[int] = None) -> Tuple:
    """``x``'s placements with everything but a split of dim 0 (and of dim
    ``keep``, where given: the heads) replicated, a partial sum reduced:
    the placements under which each rank holds whole batch rows (of its
    own heads)."""
    kept = (Shard(0),) if keep is None else (Shard(0), Shard(keep % x.dim()))
    return tuple(p if p in kept else Replicate() for p in x.placements)


def rows(x):
    """``x`` redistributed to :func:`batch_placements` (a DTensor), else
    ``x``: where the next op needs every column of a rank's rows."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, batch_placements(x))


def split_like(x, dim: int, ref, ref_dim: int):
    """The DTensor ``x`` split on ``dim`` over each mesh dim where ``ref``
    splits ``ref_dim`` (a replicated ``x`` is only sliced there: no
    communication), its other placements as they are; a plain ``x`` as
    it is."""
    if not isinstance(x, DTensor) or not isinstance(ref, DTensor):
        return x
    want = [Shard(dim % x.dim()) if pr == Shard(ref_dim % ref.dim()) else px
            for px, pr in zip(x.placements, ref.placements)]
    return x.redistribute(x.device_mesh, want)


def local_offset(x: DTensor, dim: int) -> Tuple[int, int]:
    """(start, length) along ``dim`` of the block of ``x`` this rank holds."""
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return offset[dim], shape[dim]


def _grad_placements(a: DTensor, out: Sequence) -> list:
    """Where ``a``'s gradient lies when ``out`` (the output's placements)
    splits a mesh dim that ``a`` is replicated over, or is a partial sum
    over it: each rank's gradient is then its own rows' (heads', experts')
    share, a partial sum."""
    return [Partial() if p == Replicate() and isinstance(o, (Shard, Partial))
            else p for p, o in zip(a.placements, out)]


def run_local(fn, *args, out=None):
    """``fn`` on each DTensor's local shard, every DTensor as it is placed
    (the caller placed them), plain arguments as they are; ``fn(*args)``
    where no DTensor is among ``args``.  ``out`` gives the output's
    placements (a list), or a tuple of them for several outputs; by
    default the first DTensor's.  Differentiable: a gradient leaves in
    its input's placements, except where the output splits a mesh dim the
    input is replicated over (a parameter, a head-sliced K/V), where it
    is a partial sum (:func:`_grad_placements`)."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    out = list(dts[0].placements) if out is None else out
    first = out[0] if isinstance(out, tuple) else out
    return local_map(
        fn, out_placements=out,
        in_placements=tuple(list(a.placements) if isinstance(a, DTensor)
                            else None for a in args),
        in_grad_placements=tuple(_grad_placements(a, first)
                                 if isinstance(a, DTensor) else None
                                 for a in args),
        device_mesh=dts[0].device_mesh)(*args)


def on_local_shards(fn, *args, keep: Optional[int] = None):
    """``fn(*args)`` where no DTensor is among ``args``; else ``fn`` on each
    DTensor's local shard, every DTensor first resharded to its
    :func:`batch_placements` (with its split of dim ``keep`` kept: a
    parameter enters replicated), the output taking the first DTensor's,
    which holds the batch (and the heads).  Differentiable as
    :func:`run_local`."""
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    placed = [a.redistribute(a.device_mesh, batch_placements(
        a, keep if keep is not None and a.dim() > 1 else None))
              if isinstance(a, DTensor) else a for a in args]
    return run_local(fn, *placed)


# the mesh dim over which weights stay split for their products (tensor
# parallelism); a weight's split over any other mesh dim (fsdp) is
# gathered where it is read
TP_AXIS = "model"


def compute_placements(p: DTensor) -> list:
    """The placements a parameter is read in: its split over ``TP_AXIS``
    kept, every other mesh dim replicated."""
    return [pl if name == TP_AXIS else Replicate()
            for name, pl in zip(p.device_mesh.mesh_dim_names, p.placements)]


def gathered(p):
    """The DTensor parameter ``p`` in :func:`compute_placements` (a
    differentiable all-gather over the fsdp dims, whose gradient goes back
    to ``p``'s placements as a reduce-scatter); a plain ``p`` as it is."""
    if not isinstance(p, DTensor):
        return p
    want = compute_placements(p)
    if list(p.placements) == want:
        return p
    if torch.is_grad_enabled():
        return p.redistribute(p.device_mesh, want)
    # serving: no graph to keep, and an autograd Function under inference
    # mode would detach the parameter in place, which DTensor cannot
    with torch.inference_mode(False), torch.no_grad():
        return p.redistribute(p.device_mesh, want)


def linear(x, w):
    """``x @ w`` with ``w`` (in, out) as it is placed: a split of ``out``
    is a column-parallel product (``x`` read whole there, the output split
    on its last dim), a split of ``in`` a row-parallel one (``x`` split on
    its last dim to match, the partial sums reduced).  ``x`` keeps its
    batch split; a weight is never gathered here."""
    if not isinstance(w, DTensor):
        return x @ w
    last = x.dim() - 1
    want = [Shard(last) if pw == Shard(0)
            else px if px == Shard(0) else Replicate()
            for px, pw in zip(x.placements, w.placements)]
    y = x.redistribute(x.device_mesh, want) @ w
    return y.redistribute(y.device_mesh,
                          [Replicate() if p.is_partial() else p
                           for p in y.placements])


def unflatten_heads(x, n: int):
    """``x`` (..., n * d) as (..., n, d).  A DTensor split on its last dim
    stays split (over heads) where ``n`` divides the split, and is first
    gathered there otherwise (phi4's 24 heads on a 16-way ``model``)."""
    if isinstance(x, DTensor):
        last = x.dim() - 1
        mesh = x.device_mesh
        want = [Replicate() if p == Shard(last) and n % mesh.size(i) else p
                for i, p in enumerate(x.placements)]
        if want != list(x.placements):
            x = x.redistribute(mesh, want)
    return _pinned(x.reshape(*x.shape[:-1], n, x.shape[-1] // n))


def flatten_heads(x):
    """``x`` (..., n, d) as (..., n * d), the inverse of
    :func:`unflatten_heads`."""
    return _pinned(x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1]))


def _pinned(x):
    """A DTensor view pinned to its placements: its gradient is
    redistributed to them before the view's backward, which cannot split
    a merged dim unevenly (40 heads over 16 ranks)."""
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, x.placements)
    return x


class _Apply(nn.Module):
    """``fn(module, *args)`` as a forward, so that
    ``torch.func.functional_call`` can stand other tensors in for
    ``module``'s parameters."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.m = module

    def forward(self, fn, *args):
        return fn(self.m, *args)


def with_gathered_params(module: nn.Module, fn, *args):
    """``fn(module, *args)`` with ``module``'s DTensor parameters read in
    :func:`compute_placements`: gathered over every mesh dim but
    ``TP_AXIS`` here, and dropped when ``fn`` returns.  A split over
    ``TP_AXIS`` stays split: the products run tensor-parallel
    (:func:`linear`).  Called inside a remat region, the recompute gathers
    again, so that one layer's weights are gathered at a time.  With plain
    parameters it is ``fn(module, *args)``.  It reads the parameters,
    never the thread-local rules: on the card a recompute runs on
    autograd's device thread, where ``activation_rules`` is not set."""
    return call_with(module, {k: gathered(p) for k, p in
                              module.named_parameters()
                              if isinstance(p, DTensor)}, fn, *args)


def call_with(module: nn.Module, tensors: Dict[str, torch.Tensor], fn,
              *args):
    """``fn(module, *args)`` with ``tensors`` (by parameter name) standing
    in for ``module``'s parameters (``torch.func.functional_call``)."""
    if not tensors:
        return fn(module, *args)
    return torch.func.functional_call(
        _Apply(module), {f"m.{k}": t for k, t in tensors.items()},
        (fn,) + args)


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


def placed_like(x, ref):
    """``x`` in ``ref``'s placements where both are DTensors, else ``x``."""
    if isinstance(x, DTensor) and isinstance(ref, DTensor) \
            and x.placements != ref.placements:
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def zeros_placed(shape, dtype, device, spec, mesh) -> DTensor:
    """A zero DTensor of global ``shape`` placed by ``spec``, each rank
    allocating its own block only."""
    pl = placements(spec, mesh)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def cache_spec(name: str, shape: Sequence[int], mesh,
               rules: Dict[str, Tuple[str, ...]]) -> PartitionSpec:
    """The spec of the decode-cache leaf ``name`` (the reference's
    ``launch/dryrun.py:cache_shardings``): self and cross K/V over
    ``kv_heads`` where the tensor split divides the KV heads, else over
    ``kv_seq``; MLA's latent and rope key over ``kv_seq``; SSM and WKV
    states over ``heads``; the conv tail over ``tensor``; token shifts
    over the batch only."""
    shp = mesh_shape(mesh)
    tp_size = 1
    for a in rules.get("tensor", ()):
        tp_size *= shp[a]
    if name in ("k", "v", "xk", "xv"):
        if tp_size > 1 and shape[-2] % tp_size == 0:
            logical = ("batch", None, "kv_heads", None)
        else:
            logical = ("batch", "kv_seq", None, None)
    elif name in ("latent", "k_rope"):
        logical = ("batch", "kv_seq", None)
    elif name in ("ssm", "state"):
        logical = ("batch", "heads", None, None)
    elif name == "conv":
        logical = ("batch", None, "tensor")
    elif name in ("shift_t", "shift_c"):
        logical = ("batch", None, None)
    else:
        logical = (None,) * len(shape)
    return spec_for(shape, logical[:len(shape)], mesh, rules)


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


def distribute(t: torch.Tensor, mesh, pl) -> DTensor:
    """``t`` (the same values on every rank) as a DTensor with placements
    ``pl``; a meta tensor (the dry run's) gets its rank's block shape
    directly, without splitting the whole tensor."""
    if not t.is_meta:
        return distribute_tensor(t, mesh, pl)
    local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
    return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"),
                              mesh, pl, run_check=False, shape=t.shape,
                              stride=t.stride())


def shard_module(module: nn.Module, mesh, rules: Optional[Dict] = None):
    """Place ``module``'s parameters (the same values on every rank) on
    ``mesh`` by :func:`param_spec_tree`, in place; returns ``module``."""
    specs = param_spec_tree(module, mesh, rules)
    for name, p in list(module.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        setattr(module.get_submodule(mod_name), attr, nn.Parameter(
            distribute(p.detach(), mesh, specs[name].placements()),
            requires_grad=p.requires_grad))
    return module
