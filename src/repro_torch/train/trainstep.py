"""The training step (port of ``repro/train/trainstep.py``): microbatched
gradient accumulation, remat, one optimizer update.

``global_batch`` is split into ``cfg.microbatch`` contiguous slices
(``reshape(n_mb, B // n_mb, ...)``, as the reference); each slice's loss is
differentiated by autograd, its gradients are summed in ``cfg.accum_dtype``
and the sum divided by ``n_mb``.  Parameters stay float32 (master); compute
casts to ``cfg.compute_dtype`` inside the model.  The step runs eagerly on
the parameters' device: on a card, attention's forward and backward are
the flash kernels.  One device, no sharding: the reference's ``mesh`` and
``rules`` have no counterpart here yet.

``TrainState.params`` is the model (``lm.LM``), updated in place by the
optimizer; ``opt`` is the optimizer's state over
``dict(params.named_parameters())``; ``step`` an int32 scalar tensor.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import lm
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


def make_train_step(cfg: ModelConfig, optimizer: Optional[Optimizer] = None):
    optimizer = optimizer or make_optimizer(cfg.optimizer)
    n_mb = max(1, cfg.microbatch)
    acc_dt = L.dtype_of(cfg.accum_dtype)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = named_params(state.params)
        device = next(iter(params.values())).device
        batch = to_device(batch, device)

        def split(x):  # (B, ...) -> (n_mb, B/n_mb, ...)
            return x.reshape((n_mb, x.shape[0] // n_mb) + tuple(x.shape[1:]))

        mbs = {k: split(v) for k, v in batch.items()}
        names = list(params)
        gsum = {k: torch.zeros(p.shape, dtype=acc_dt, device=device)
                for k, p in params.items()}
        lsum = 0.0
        for i in range(n_mb):
            loss, _ = lm.loss_fn(state.params, {k: v[i] for k, v in mbs.items()},
                                 cfg)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
            for k, g in zip(names, grads):
                gsum[k] += g.to(acc_dt)
            lsum = lsum + loss.detach()
        grads = {k: g / n_mb for k, g in gsum.items()}
        _, new_opt = optimizer.update(grads, state.opt, params)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                               for g in grads.values()))
        metrics = {"loss": lsum / n_mb, "grad_norm": gnorm,
                   "step": state.step + 1}
        return TrainState(state.params, new_opt, state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        device = next(params.parameters()).device
        _, metrics = lm.loss_fn(params, to_device(batch, device), cfg)
        return metrics
    return eval_step
