"""The system under test: the port's configuration and model, built from a
benchmark configuration file and filled with the seed's weights.

The port's registered config of ``port.arch`` is taken with
``port.overrides`` and held to the file's ``model`` group, the sizes the
reference runs, key by key as ``port.fields`` maps them onto the port's
config fields, so that the two sides cannot drift apart.  The model is
built on the meta device, placed on the card uninitialised, and every
parameter is written from :func:`weights.draw`; its names and shapes must
be exactly the reference's.
"""
from __future__ import annotations

import torch

from portbench.lib import weights
from portbench.reference import lm as ref

def port_config(config: dict):
    """The port's ``ModelConfig`` for a benchmark configuration."""
    from repro_torch.configs import registry
    port = config["port"]
    cfg = registry.get_config(port["arch"]).replace(**port["overrides"])
    cfg.validate()
    m = config["model"]
    wrong = {k: (m[k], getattr(cfg, f))
             for k, f in port["fields"].items() if m[k] != getattr(cfg, f)}
    kinds = [s.kind for s in cfg.plan]
    if kinds != ref.plan(m):
        wrong["plan"] = (ref.plan(m), kinds)
    prec = config["precision"]
    if (cfg.param_dtype, cfg.compute_dtype) != (prec["params"], prec["compute"]):
        wrong["precision"] = (prec, (cfg.param_dtype, cfg.compute_dtype))
    if wrong:
        raise ValueError(f"{config['name']}: the port's config differs from "
                         f"the file's model group (file, port): {wrong}")
    return cfg


def port_model(cfg, config: dict, seed: int, device):
    """The port's ``lm.LM`` on ``device`` with the seed's weights."""
    from repro_torch.models import lm
    with torch.device("meta"):
        model = lm.init_params(cfg, torch.Generator(), "meta")
    model = model.to_empty(device=device)
    params = dict(model.named_parameters())
    shapes = ref.param_shapes(config["model"])
    have = {k: tuple(p.shape) for k, p in params.items()}
    want = {k: tuple(s) for k, s in shapes.items()}
    if have != want:
        differ = [k for k in have if k in want and have[k] != want[k]]
        raise ValueError(f"{config['name']}: the port's parameters differ from "
                         f"the reference's: only the port's "
                         f"{sorted(set(have) - set(want))}, only the "
                         f"reference's {sorted(set(want) - set(have))}, "
                         f"shapes of {differ}")
    with torch.no_grad():
        for _, leaves in weights.draw(shapes, config["init"], seed, device):
            for k, v in leaves.items():
                params[k].copy_(v)
    return model


def parameter_changes(model, config: dict, seed: int) -> dict:
    """{name: norm of the parameter's change since the seed's draw}."""
    params = dict(model.named_parameters())
    out = {}
    with torch.no_grad():
        for _, leaves in weights.draw(ref.param_shapes(config["model"]),
                                      config["init"], seed,
                                      next(iter(params.values())).device):
            for k, v in leaves.items():
                out[k] = float(torch.linalg.vector_norm(params[k].float() - v))
    return out
