"""Load the reference package's parameters into the port.

``params_from_jax(tree, cfg, device)`` takes the JAX package's params pytree
with its leaves already turned into numpy arrays (the port never sees a JAX
array) and returns the port's ``LM`` holding the same values:

  * ``embed``, ``final_norm.scale``, ``lm_head`` and ``w_img`` (the image
    projection) map by name, and so do the leaves of the top-level
    ``shared_attn`` (zamba2's shared block) and ``encoder.final_norm``;
  * ``encoder.blocks`` holds whisper's encoder layers stacked over
    ``n_enc_layers``: row r of each leaf is ``encoder.blocks.{r}``;
  * ``prologue[j]`` is layer j;
  * ``blocks[i]`` holds superblock position i stacked over ``n_repeat``:
    row r of each leaf is layer ``len(prologue) + r * len(superblock) + i``,
    whose leaves (``norm1``, ``attn``, ``norm2``, ``mlp`` (GLU, GELU or
    MoE), ``rwkv``, ``mamba``; xattn's 0-d ``xgate``, dec's ``xnorm`` and
    ``xattn``; ``norm1_post`` and ``norm2_post`` under sandwich norms; the
    MLA keys ``attn.wkv_a``, ``attn.wk_rope``, ``attn.kv_norm``,
    ``attn.wk_b``, ``attn.wv_b``; the MoE keys ``mlp.w_router``,
    ``mlp.experts_w{i,g,o}`` (stacked (n_repeat, E, ...)) and
    ``mlp.shared.*``; ``res_mlp.*`` beside a dense-residual MoE) map by
    name.  A ``shared_attn`` layer holds only the
    ``norm1`` the reference gives it, which nothing reads; it is loaded
    like any other leaf, so ``strict=True`` holds both trees to one set of
    names.

``train_state_from_jax(state_np, cfg, device)`` takes the reference's
``TrainState`` as numpy and returns the port's, so that both sides can
start a training step from one state: under AdamW, ``m`` and ``v`` mapped
through the same names as the parameters; under Adafactor, the factored
moments as the port's Adafactor keys them (``train.optimizer``): the
reference's stacked leaves keep their shapes under ``blocks.{i}.{leaf}``
and ``encoder.blocks.{leaf}``, a prologue layer's under
``layers.{j}.{leaf}``, the rest under the parameter's name.

``surrogate_from_jax(stacked, device)`` takes the reference's stacked
deep-ensemble pytree as numpy, ``[{"w": (M, din, dout), "b": (M, dout)},
...]`` (members on the leading axis), and returns the port's
``core.active.Surrogate`` holding the same members.

``snapshot_from_jax(stacked, root, X=, y=, version=, cursor=, device)``
wraps those members in the port's ``core.active.SurrogateSnapshot`` over
the same study directory, with the reference snapshot's rows, version and
bundle cursor, so that both gateways answer from one model.
"""
from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.active import Surrogate, SurrogateSnapshot
from repro_torch.models import lm

_TOP = ("embed", "final_norm", "lm_head", "prologue", "blocks", "shared_attn",
        "encoder", "w_img")


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


def _unstack(block, n, label, key) -> Dict[str, torch.Tensor]:
    """Leaves of ``block`` stacked over n rows -> {key(r, leaf name): row r}."""
    sd = {}
    for name, leaf in _flatten(block).items():
        stacked = np.asarray(leaf)
        if stacked.shape[0] != n:
            raise ValueError(f"{label}.{name}: leading dim "
                             f"{stacked.shape[0]} != {n}")
        for r in range(n):
            sd[key(r, name)] = _tensor(stacked[r])
    return sd


def _state_dict(tree, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The reference's params-shaped tree (as numpy) -> {port name: tensor}."""
    extra = sorted(set(tree) - set(_TOP))
    if extra:
        raise NotImplementedError(f"params {extra} are not parameters of the "
                                  "reference's LM")
    sd: Dict[str, torch.Tensor] = {"embed": _tensor(tree["embed"]),
                                   "final_norm.scale": _tensor(tree["final_norm"]["scale"])}
    for key in ("lm_head", "w_img"):
        if key in tree:
            sd[key] = _tensor(tree[key])
    for name, leaf in _flatten(tree.get("shared_attn", {})).items():
        sd[f"shared_attn.{name}"] = _tensor(leaf)
    if "encoder" in tree:
        enc = tree["encoder"]
        sd["encoder.final_norm.scale"] = _tensor(enc["final_norm"]["scale"])
        sd.update(_unstack(enc["blocks"], cfg.n_enc_layers, "encoder.blocks",
                           lambda r, name: f"encoder.blocks.{r}.{name}"))
    for j, layer in enumerate(tree["prologue"]):
        for name, leaf in _flatten(layer).items():
            sd[f"layers.{j}.{name}"] = _tensor(leaf)
    n_pro, n_sb = len(cfg.prologue), len(cfg.superblock)
    for i, block in enumerate(tree["blocks"]):
        sd.update(_unstack(
            block, cfg.n_repeat, f"blocks[{i}]",
            lambda r, name: f"layers.{n_pro + r * n_sb + i}.{name}"))
    return sd


def params_from_jax(tree, cfg: ModelConfig, device="cuda") -> lm.LM:
    gen = torch.Generator(device=device).manual_seed(0)
    model = lm.init_params(cfg, gen, device)
    model.load_state_dict(_state_dict(tree, cfg), strict=True)
    return model


def _adafactor_state(f_tree, names, cfg: ModelConfig, device):
    """The reference's Adafactor moments (its ``f`` tree as numpy: each
    parameter leaf a dict of ``vr``/``vc`` or ``v``) -> the port's ``f``."""
    from repro_torch.train.optimizer import layout_of, stacked_groups
    flat = _flatten({k: (dict(enumerate(v)) if isinstance(v, list) else v)
                     for k, v in f_tree.items()})
    f: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, leaf in flat.items():
        key, _, moment = name.rpartition(".")
        found = re.fullmatch(r"prologue\.(\d+)\.(.+)", key)
        if found:
            key = f"layers.{found.group(1)}.{found.group(2)}"
        f.setdefault(key, {})[moment] = _tensor(leaf).to(device)
    want = set(stacked_groups(list(names), layout_of(cfg)))
    if set(f) != want:
        raise ValueError(f"Adafactor leaves {sorted(set(f) ^ want)} do not "
                         "match the parameters")
    return f


def train_state_from_jax(state_np, cfg: ModelConfig, device="cuda"):
    """The reference's ``TrainState`` as numpy, ``(params, opt, step)`` with
    ``opt`` AdamW's ``{"m": tree, "v": tree, "step": n}`` or Adafactor's
    ``{"f": tree, "step": n}``, -> the port's ``train.trainstep.TrainState``:
    the model from ``params``, and the optimizer state keyed as the port's
    optimizer keys it."""
    from repro_torch.train.trainstep import TrainState, named_params
    params, opt, step = state_np
    model = params_from_jax(params, cfg, device)
    names = set(named_params(model))

    def moments(tree):
        sd = _state_dict(tree, cfg)
        if set(sd) != names:
            raise ValueError(f"optimizer leaves {sorted(set(sd) ^ names)} "
                             "do not match the parameters")
        return {k: v.to(device) for k, v in sd.items()}

    def int32(n):
        return torch.tensor(int(np.asarray(n)), dtype=torch.int32,
                            device=device)

    if "f" in opt:
        new_opt = {"f": _adafactor_state(opt["f"], names, cfg, device),
                   "step": int32(opt["step"])}
    else:
        new_opt = {"m": moments(opt["m"]), "v": moments(opt["v"]),
                   "step": int32(opt["step"])}
    return TrainState(model, new_opt, int32(step))


def surrogate_from_jax(stacked, device="cuda") -> Surrogate:
    layers = [{"w": _tensor(layer["w"]).to(device),
               "b": _tensor(layer["b"]).to(device)} for layer in stacked]
    n_members = layers[0]["w"].shape[0]
    for i, layer in enumerate(layers):
        if layer["w"].ndim != 3 or tuple(layer["b"].shape) != (
                n_members, layer["w"].shape[2]):
            raise ValueError(f"layer {i}: w {tuple(layer['w'].shape)}, "
                             f"b {tuple(layer['b'].shape)} are not stacked "
                             f"over {n_members} members")
    return Surrogate.from_stacked(layers, n_members)


def snapshot_from_jax(stacked, root: str, *, X, y, version: int, cursor,
                      device="cuda", **kw) -> SurrogateSnapshot:
    """A port ``SurrogateSnapshot`` over the study at ``root`` that serves
    the reference snapshot's trained members (``stacked`` as numpy, as for
    ``surrogate_from_jax``) with its rows ``X``, ``y``, its ``version`` and
    its ``Bundler.load_since`` cursor, so that a later ``refresh()`` reads
    only bundles the reference had not seen.  ``kw`` are the snapshot's
    training settings (``n_members``, ``hidden``, ``steps``, ...)."""
    sur = surrogate_from_jax(stacked, device)
    state = {"surrogate": sur, "X": np.array(X, np.float32),
             "y": np.array(y, np.float32), "version": version,
             "cursor": dict(cursor)}
    return SurrogateSnapshot(root, n_members=len(sur.params_list),
                             device=device, state=state, **kw)
