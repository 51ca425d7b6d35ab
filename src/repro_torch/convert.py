"""Load the reference package's parameters into the port.

``params_from_jax(tree, cfg, device)`` takes the JAX package's params pytree
with its leaves already turned into numpy arrays (the port never sees a JAX
array) and returns the port's ``LM`` holding the same values:

  * ``embed``, ``final_norm.scale`` and ``lm_head`` map by name, and so do
    the leaves of the top-level ``shared_attn`` (zamba2's shared block);
  * ``prologue[j]`` is layer j;
  * ``blocks[i]`` holds superblock position i stacked over ``n_repeat``:
    row r of each leaf is layer ``len(prologue) + r * len(superblock) + i``,
    whose leaves (``norm1``, ``attn``, ``norm2``, ``mlp``, ``rwkv``,
    ``mamba``) map by name.  A ``shared_attn`` layer holds only the
    ``norm1`` the reference gives it, which nothing reads; it is loaded
    like any other leaf, so ``strict=True`` holds both trees to one set of
    names.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm

_TOP = ("embed", "final_norm", "lm_head", "prologue", "blocks", "shared_attn")


def _flatten(tree, prefix=""):
    """{'attn': {'wq': a}} -> {'attn.wq': a}."""
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def _tensor(a) -> torch.Tensor:
    # a float32 copy: writable for torch, and numpy cannot hand bf16 to torch
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(tree, cfg: ModelConfig, device="cuda") -> lm.LM:
    extra = sorted(set(tree) - set(_TOP))
    if extra:
        raise NotImplementedError(f"params {extra} belong to layer kinds the "
                                  "port does not run yet")
    sd: Dict[str, torch.Tensor] = {"embed": _tensor(tree["embed"]),
                                   "final_norm.scale": _tensor(tree["final_norm"]["scale"])}
    if "lm_head" in tree:
        sd["lm_head"] = _tensor(tree["lm_head"])
    for name, leaf in _flatten(tree.get("shared_attn", {})).items():
        sd[f"shared_attn.{name}"] = _tensor(leaf)
    for j, layer in enumerate(tree["prologue"]):
        for name, leaf in _flatten(layer).items():
            sd[f"layers.{j}.{name}"] = _tensor(leaf)
    n_pro, n_sb = len(cfg.prologue), len(cfg.superblock)
    for i, block in enumerate(tree["blocks"]):
        for name, leaf in _flatten(block).items():
            stacked = np.asarray(leaf)
            if stacked.shape[0] != cfg.n_repeat:
                raise ValueError(f"blocks[{i}].{name}: leading dim "
                                 f"{stacked.shape[0]} != n_repeat {cfg.n_repeat}")
            for r in range(cfg.n_repeat):
                sd[f"layers.{n_pro + r * n_sb + i}.{name}"] = _tensor(stacked[r])
    gen = torch.Generator(device=device).manual_seed(0)
    model = lm.init_params(cfg, gen, device)
    model.load_state_dict(sd, strict=True)
    return model
