"""The training step (port of ``repro/train/trainstep.py``): microbatched
gradient accumulation, remat, one optimizer update.

``global_batch`` is split into ``cfg.microbatch`` contiguous slices
(``reshape(n_mb, B // n_mb, ...)``, as the reference); each slice's loss is
differentiated by autograd, its gradients are summed in ``cfg.accum_dtype``
and the sum divided by ``n_mb``.  Parameters stay float32 (master); compute
casts to ``cfg.compute_dtype`` inside the model.  The step runs eagerly on
the parameters' device: on a card, attention's forward and backward are
the flash kernels.

Under a ``mesh`` (a ``DeviceMesh`` with named dims, every rank running the
step) the step runs under ``activation_rules(mesh, rules)``.  The state
comes placed: parameters and optimizer state are DTensors, by
``param_spec_tree`` and ``opt_shardings`` (``shard_state``, or ``restore``
with those shardings).  Each microbatch is split over the batch axes
(``shard_input``).  The forward reads each parameter whole (a
differentiable redistribute to ``Replicate()``, an all-gather of a split
weight) and DTensor takes its gradient back to the parameter's
placements (a reduce-scatter).  A layer's weights are gathered inside its
remat region, so one layer's are whole at a time (the recompute gathers
them again); the embedding, norms, encoder and shared blocks are gathered
once for the microbatch.  The ``model`` axis does no tensor parallelism:
its ranks compute the same rows, where GSPMD, the reference's, shards the
products themselves.  Activations stay batch-sharded, and
attention and the scans run on each rank's local rows
(``sharding.on_local_shards``): the flash kernels on the card, never a
plain version because the input is a DTensor.  The metrics come back as
plain tensors.

``TrainState.params`` is the model (``lm.LM``), updated in place by the
optimizer; ``opt`` is the optimizer's state over
``dict(params.named_parameters())``; ``step`` an int32 scalar tensor.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.parallel import sharding as shd
from repro_torch.train.optimizer import Optimizer, make_optimizer


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor


def named_params(params) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters())


def init_state(gen: torch.Generator, cfg: ModelConfig,
               optimizer: Optional[Optimizer] = None,
               device=None) -> TrainState:
    """Random parameters drawn from ``gen`` (on its device), moved to
    ``device`` (default: ``gen``'s), and fresh optimizer state there.  A
    CPU generator gives one model on every device."""
    optimizer = optimizer or make_optimizer(cfg.optimizer)
    device = torch.device(device) if device is not None else gen.device
    params = lm.init_params(cfg, gen, gen.device).to(device)
    return TrainState(params, optimizer.init(named_params(params)),
                      torch.zeros((), dtype=torch.int32, device=device))


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (the data pipeline's) or tensors on
    ``device``; numpy is copied first (a view of a read-only buffer would
    make ``torch.from_numpy`` warn)."""
    return {k: (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
                else v).to(device)
            for k, v in batch.items()}


def place_params(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Make each named parameter of ``model`` the given tensor (a DTensor
    from ``restore(..., shardings=)`` or :func:`shard_state`)."""
    for name, t in tensors.items():
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        setattr(mod, attr, nn.Parameter(t, requires_grad=True))


def opt_shardings(opt, params: Dict[str, torch.Tensor],
                  specs: Dict[str, "shd.NamedSharding"]):
    """Where optimizer state ``opt`` lives on the mesh of ``specs`` (the
    parameters' ``param_spec_tree``), in the form ``restore(...,
    shardings=)`` takes: a leaf under a parameter's name with its shape is
    placed like the parameter (AdamW's moments, the error feedback), any
    other leaf of more than one element is replicated (Adafactor's
    factored moments), and a scalar (the step) is None, a plain tensor."""
    mesh = next(iter(specs.values())).mesh
    whole = shd.NamedSharding(mesh, shd.P())

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k if k in specs else name)
                    for k, v in node.items()}
        if node.dim() == 0:
            return None
        if name is not None and node.shape == params[name].shape:
            return specs[name]
        return whole
    return walk(opt)


def shard_state(state: TrainState, mesh, rules=None) -> TrainState:
    """``state`` (the same values on every rank) with its parameters and
    optimizer state distributed to their placements on ``mesh``, once:
    the step takes the state as placed."""
    params = named_params(state.params)
    specs = shd.param_spec_tree(params, mesh, rules)
    osh = opt_shardings(state.opt, params, specs)
    place_params(state.params, {
        k: distribute_tensor(p.detach(), mesh, specs[k].placements())
        for k, p in params.items()})

    def place(node, sh):
        if isinstance(node, dict):
            return {k: place(v, sh[k]) for k, v in node.items()}
        return node if sh is None else distribute_tensor(node, mesh,
                                                         sh.placements())
    return state._replace(opt=place(state.opt, osh))


def shard_input(x: torch.Tensor, mesh) -> DTensor:
    """A batch tensor that every rank holds whole, split over the batch
    axes of the active rules (``("batch", None, ...)``)."""
    ctx = shd.current()
    spec = shd.spec_for(x.shape, ("batch",) + (None,) * (x.dim() - 1), mesh,
                        ctx.rules)
    return distribute_tensor(x, mesh, shd.placements(spec, mesh))


def _plain(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


class _Loss(nn.Module):
    """``lm.loss_fn`` over ``model`` and, given ``leaves``, the gradients
    of its loss with respect to them, as one module call: under
    ``torch.func.functional_call`` the replicated parameters stand in for
    the model's for the forward and the backward alike, so that a remat
    recompute reads the same tensors as the forward did."""

    def __init__(self, model: nn.Module, cfg: ModelConfig, leaves=None):
        super().__init__()
        self.model, self.cfg, self.leaves = model, cfg, leaves

    def forward(self, batch):
        loss, metrics = lm.loss_fn(self.model, batch, self.cfg)
        # a parameter the loss never reads (zamba2's shared block's norm1)
        # gets a zero gradient, as jax.grad gives it
        grads = (None if self.leaves is None
                 else torch.autograd.grad(loss, self.leaves, allow_unused=True,
                                          materialize_grads=True))
        return loss, metrics, grads


def _run_loss(model, batch, cfg, mesh, leaves=None):
    """(loss, metrics, gradients of ``leaves`` or None).  Under a mesh the
    forward reads every parameter whole through a differentiable
    redistribute, and the gradients reach the parameters' own placements
    back through it: the layers' weights one layer at a time, inside its
    remat region (``lm.forward_train``), the rest (embedding, norms,
    encoder, shared blocks) gathered here for the whole microbatch."""
    fn = _Loss(model, cfg, leaves)
    if mesh is None:
        return fn(batch)
    full = {f"model.{k}": p.redistribute(p.device_mesh,
                                         [Replicate()] * p.device_mesh.ndim)
            for k, p in model.named_parameters()
            if not k.startswith("layers.")}
    return torch.func.functional_call(fn, full, (batch,))


def make_train_step(cfg: ModelConfig, optimizer: Optional[Optimizer] = None,
                    mesh=None, rules=None):
    optimizer = optimizer or make_optimizer(cfg.optimizer)
    n_mb = max(1, cfg.microbatch)
    acc_dt = L.dtype_of(cfg.accum_dtype)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        with shd.activation_rules(mesh, rules):
            params = named_params(state.params)
            device = (torch.device(mesh.device_type) if mesh is not None
                      else next(iter(params.values())).device)
            batch = to_device(batch, device)

            def split(x):  # (B, ...) -> (n_mb, B/n_mb, ...)
                return x.reshape((n_mb, x.shape[0] // n_mb)
                                 + tuple(x.shape[1:]))

            mbs = {k: split(v) for k, v in batch.items()}
            names = list(params)
            gsum = {k: torch.zeros_like(p, dtype=acc_dt)
                    for k, p in params.items()}
            lsum = 0.0
            for i in range(n_mb):
                mb = {k: v[i] for k, v in mbs.items()}
                if mesh is not None:
                    mb = {k: shard_input(v, mesh) for k, v in mb.items()}
                loss, _, grads = _run_loss(state.params, mb, cfg, mesh,
                                           [params[k] for k in names])
                for k, g in zip(names, grads):
                    gsum[k] += g.to(acc_dt)
                lsum = lsum + loss.detach()
            grads = {k: g / n_mb for k, g in gsum.items()}
            _, new_opt = optimizer.update(grads, state.opt, params)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                                   for g in grads.values()))
            metrics = {"loss": _plain(lsum / n_mb), "grad_norm": _plain(gnorm),
                       "step": state.step + 1}
            return TrainState(state.params, new_opt, state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ModelConfig, mesh=None, rules=None):
    @torch.no_grad()
    def eval_step(params, batch):
        with shd.activation_rules(mesh, rules):
            if mesh is None:
                batch = to_device(batch, next(params.parameters()).device)
            else:
                batch = {k: shard_input(v, mesh) for k, v in to_device(
                    batch, torch.device(mesh.device_type)).items()}
            _, metrics, _ = _run_loss(params, batch, cfg, mesh)
        return {k: _plain(v) for k, v in metrics.items()}
    return eval_step
