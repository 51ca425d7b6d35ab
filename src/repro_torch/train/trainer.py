"""Host-side training loop with checkpoint/restart fault tolerance (port of
``repro/train/trainer.py``).

State is checkpointed every ``ckpt_every`` steps and at the last step
(async, atomic; ``ckpt_every`` 0 saves none, for a run whose state is
not kept); ``Trainer.restore_or_init`` resumes from the latest
checkpoint, so a killed run relaunched with the same workdir continues.
Per-step wall times are journaled (host clock around a step that ends in
reading the loss, which waits for the device); steps slower than
``straggler_factor`` x the running median are counted.  The step runs
eagerly on ``device`` (the card unless the CPU is asked for).

With a ``mesh`` (a DeviceMesh over which every rank runs this loop) the
step runs under the sharding ``rules``: the parameters and the optimizer
state are DTensors placed by ``param_spec_tree`` and ``opt_shardings``,
initialized on the host or restored straight onto the mesh (``restore(..., shardings=)``, the elastic-rescale path: the
checkpoint may come from any topology), and checkpoints are gathered and
written by rank 0.
"""
from __future__ import annotations

import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import param_spec_tree
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.trainstep import (TrainState, init_state,
                                         make_train_step, named_params,
                                         opt_shardings, place_params,
                                         shard_state)


def state_tree(state: TrainState):
    """The checkpointed tree: (parameters by name, optimizer state, step)."""
    return (named_params(state.params), state.opt, state.step)


class Trainer:
    def __init__(self, cfg: ModelConfig, workdir: str, data: Iterator,
                 mesh=None, rules=None, lr: float = 3e-4,
                 ckpt_every: int = 20, keep: int = 3,
                 straggler_factor: float = 3.0, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.data = data
        self.mesh, self.rules = mesh, rules
        self.device = torch.device(device if mesh is None
                                   else mesh.device_type)
        self.optimizer = make_optimizer(cfg.optimizer, lr=lr, cfg=cfg)
        self.step_fn = make_train_step(cfg, self.optimizer, mesh, rules)
        self.ckpt = CheckpointManager(os.path.join(workdir, "ckpt"), keep=keep)
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.seed = seed
        self.step_times: list = []
        self.stragglers = 0
        self.history: list = []

    def restore_or_init(self) -> TrainState:
        # drawn on the CPU: one seed gives one model on every device
        gen = torch.Generator().manual_seed(self.seed)
        state = init_state(gen, self.cfg, self.optimizer, self.device)
        latest = self.ckpt.latest_step()
        if latest is None:
            return (state if self.mesh is None
                    else shard_state(state, self.mesh, self.rules))
        shardings = None
        if self.mesh is not None:
            params = named_params(state.params)
            specs = param_spec_tree(params, self.mesh, self.rules)
            shardings = (specs, opt_shardings(state.opt, params, specs), None)
        params, opt, step = self.ckpt.restore(latest, like=state_tree(state),
                                              shardings=shardings)
        place_params(state.params, params)
        return TrainState(state.params, opt, step)

    def train(self, num_steps: int, state: Optional[TrainState] = None
              ) -> TrainState:
        state = state if state is not None else self.restore_or_init()
        start = int(state.step)
        for i in range(start, num_steps):
            batch = next(self.data)
            t0 = time.monotonic()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-50:]))
            if len(self.step_times) > 5 and dt > self.straggler_factor * med:
                self.stragglers += 1
            self.history.append({"step": i + 1, "loss": loss, "dt": dt})
            if self.ckpt_every > 0 and ((i + 1) % self.ckpt_every == 0
                                        or (i + 1) == num_steps):
                self.ckpt.save(i + 1, state_tree(state))
        self.ckpt.wait()
        return state
