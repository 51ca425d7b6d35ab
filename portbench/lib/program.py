"""The system under test: the port's configuration and model, built from a
benchmark configuration file and filled with the seed's weights.

The port's registered config of ``port.arch`` is taken with
``port.overrides`` and held to the file's ``model`` group, the sizes the
reference runs, key by key as ``port.fields`` maps them onto the port's
config fields, so that the two sides cannot drift apart.  The model is
built on the meta device, placed on the card uninitialised, and every
parameter is written from :func:`weights.draw`; its names and shapes must
be exactly the reference's.  Under a mesh (a cell on several cards) each
parameter is placed as the port's ``Trainer`` places it
(``sharding.param_spec_tree``), one drawn group at a time, and AdamW's
state is made in the placements ``trainstep.opt_shardings`` gives it.
"""
from __future__ import annotations

import torch

from portbench import layers
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
    # an entry names the kind, or the kind and its MLP ("mla+moe")
    kinds = [s.kind if layers.split(e)[1] is None else f"{s.kind}+{s.mlp}"
             for s, e in zip(cfg.plan, ref.plan(m))]
    if len(cfg.plan) != len(ref.plan(m)) or kinds != ref.plan(m):
        wrong["plan"] = (ref.plan(m), [f"{s.kind}+{s.mlp}" for s in cfg.plan])
    prec = config["precision"]
    if (cfg.param_dtype, cfg.compute_dtype) != (prec["params"], prec["compute"]):
        wrong["precision"] = (prec, (cfg.param_dtype, cfg.compute_dtype))
    if wrong:
        raise ValueError(f"{config['name']}: the port's config differs from "
                         f"the file's model group (file, port): {wrong}")
    return cfg


def _meta_model(cfg, config: dict):
    """The port's ``lm.LM`` on the meta device, its parameters held to the
    reference's names and shapes; and those shapes."""
    from repro_torch.models import lm
    with torch.device("meta"):
        model = lm.init_params(cfg, torch.Generator(), "meta")
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
    return model, shapes


def port_model(cfg, config: dict, seed: int, device):
    """The port's ``lm.LM`` on ``device`` with the seed's weights."""
    model, shapes = _meta_model(cfg, config)
    model = model.to_empty(device=device)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for _, leaves in weights.draw(shapes, config["init"], seed, device):
            for k, v in leaves.items():
                params[k].copy_(v)
    return model


def placed_state(cfg, config: dict, seed: int, device, optimizer, mesh,
                 rules):
    """(model, optimizer state) on ``mesh`` with the seed's weights: each
    parameter a DTensor in its ``param_spec_tree`` placements, made from
    its drawn group (one group whole on the card at a time), and the
    optimizer's state zeros in ``opt_shardings``' placements, as
    ``trainstep.shard_state`` places a state ``Trainer`` made."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import trainstep
    model, shapes = _meta_model(cfg, config)
    meta = dict(model.named_parameters())
    specs = shd.param_spec_tree(meta, mesh, rules)
    opt = optimizer.init(meta)
    osh = trainstep.opt_shardings(opt, meta, specs)
    with torch.no_grad():
        for _, leaves in weights.draw(shapes, config["init"], seed, device):
            # each leaf a tensor of its own: a replicated or a first-axis
            # shard may be a view that would keep the whole group alive
            placed = {k: shd.distribute(v.clone(), mesh, specs[k].placements())
                      for k, v in leaves.items()}
            trainstep.place_params(model, placed)

    def zeros(node, sh):
        if isinstance(node, dict):
            return {k: zeros(v, sh[k]) for k, v in node.items()}
        if sh is None:
            return torch.zeros(node.shape, dtype=node.dtype, device=device)
        return shd.zeros_placed(node.shape, node.dtype, device, sh.spec, mesh)
    return model, zeros(opt, osh)


def whole(t):
    """A parameter or a state's leaf as one plain tensor (a DTensor
    gathered)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def parameter_changes(model, config: dict, seed: int) -> dict:
    """{name: norm of the parameter's change since the seed's draw}."""
    params = dict(model.named_parameters())
    out = {}
    with torch.no_grad():
        for _, leaves in weights.draw(ref.param_shapes(config["model"]),
                                      config["init"], seed,
                                      next(iter(params.values())).device):
            for k, v in leaves.items():
                out[k] = float(torch.linalg.vector_norm(
                    whole(params[k]).float() - v))
    return out
