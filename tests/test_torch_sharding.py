"""The port's sharding rules against the reference's, leaf for leaf.

``spec_for`` and ``param_spec`` read only ``mesh.shape``, so both sides
take a stub mesh of the production shapes, (data 16, model 16) and
(pod 2, data 16, model 16), with and without the arch's rule overrides.
For every arch, reduced and full (the full models built on the meta
device, the reference's as ``jax.eval_shape``), the port's spec of every
parameter equals the reference's ``PartitionSpec`` of the leaf it was
loaded from.  The reference stacks ``blocks[i]`` over ``n_repeat`` and
whisper's encoder blocks over ``n_enc_layers`` where the port holds one
tensor a layer (``convert.py``), and ``param_spec`` pads a stacked leaf's
logical axes with leading Nones: so the port's spec equals the
reference's without its leading stacked dim.  Then the reference's own
cases of ``spec_for`` / ``param_spec`` / ``constrain``
(``tests/test_substrate.py``) on both sides, and ``placements``.
"""
import types

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.parallel import sharding as jshd
from repro_torch.configs import registry as preg
from repro_torch.models import lm
from repro_torch.parallel import sharding as shd

MESHES = {"data16_model16": {"data": 16, "model": 16},
          "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16}}


def _stub(shape):
    return types.SimpleNamespace(shape=dict(shape))


def _ref_rules(mesh, rules):
    r = dict(jshd.DEFAULT_RULES)
    if rules:
        r.update(rules)
    return {k: tuple(a for a in v if a in mesh.shape) for k, v in r.items()}


def _ref_specs(params, cfg, mesh, rules):
    """{port parameter name: the reference's spec of the leaf it is loaded
    from, less the stacked dim}, by convert.py's name mapping."""
    r = _ref_rules(mesh, rules)
    n_pro, n_sb = len(cfg.prologue), len(cfg.superblock)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
        spec = tuple(jshd.param_spec(keys, leaf.shape, mesh, r))
        if keys[0] == "blocks":
            i, rest = int(keys[1]), ".".join(keys[2:])
            for rep in range(cfg.n_repeat):
                out[f"layers.{n_pro + rep * n_sb + i}.{rest}"] = spec[1:]
        elif keys[:2] == ("encoder", "blocks"):
            for rep in range(cfg.n_enc_layers):
                out[f"encoder.blocks.{rep}.{'.'.join(keys[2:])}"] = spec[1:]
        elif keys[0] == "prologue":
            out[f"layers.{keys[1]}.{'.'.join(keys[2:])}"] = spec
        else:
            out[".".join(keys)] = spec
    return out


def _configs(arch, size):
    if size == "reduced":
        return jreg.reduced_config(arch), preg.reduced_config(arch)
    return jreg.get_config(arch), preg.get_config(arch)


def test_arch_rules_are_the_reference():
    assert preg.ARCH_RULES == jreg.ARCH_RULES
    for arch in jreg.ARCHS:
        assert preg.arch_rules(arch) == jreg.arch_rules(arch)


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_param_specs_equal_the_reference(arch, size):
    jcfg, pcfg = _configs(arch, size)
    jparams = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    model = lm.init_params(pcfg, torch.Generator().manual_seed(0),
                           torch.device("meta"))
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    n_sharded = 0
    for mesh_shape in MESHES.values():
        mesh = _stub(mesh_shape)
        for rules in (None, preg.arch_rules(arch)):
            want = _ref_specs(jparams, jcfg, mesh, rules)
            got = shd.param_spec_tree(model, mesh, rules)
            assert set(got) == set(want) == set(shapes)
            for name, sharding in got.items():
                assert sharding.mesh is mesh
                assert tuple(sharding.spec) == want[name], (name, shapes[name])
                n_sharded += any(p is not None for p in sharding.spec)
    assert n_sharded  # the rules shard something of every arch


# the reference's cases (tests/test_substrate.py), on both sides
FAKE = _stub(MESHES["pod2_data16_model16"])
SUBSTRATE_CASES = [
    ("spec_for", ((2, 24, 128), (None, "heads", None)), (None, None, None)),
    ("spec_for", ((2, 32, 128), (None, "heads", None)), (None, "model", None)),
    ("spec_for", ((256, 4096), ("batch", None)), (("pod", "data"), None)),
    ("spec_for", ((1, 4096), ("batch", None)), (None, None)),
    ("spec_for", ((64, 32), ("vocab", "heads")), ("model", None)),
    ("param_spec", (("blocks", "0", "attn", "wq"), (12, 4096, 4096)),
     (None, "data", "model")),
    ("param_spec", (("embed",), (256000, 4608)), ("model", None)),
    ("param_spec", (("embed",), (49155, 4096)), (None, None)),
    # whisper's pure data parallelism: batch over every axis
    ("spec_for", ((512, 1500), ("dp_only", None)),
     (("pod", "data", "model"), None)),
    ("param_spec", (("layers", "3", "attn", "wo"), (4096, 4096)),
     ("model", "data")),
    ("param_spec", (("xgate",), ()), ()),
]


@pytest.mark.parametrize("fn,args,want", SUBSTRATE_CASES)
def test_substrate_cases(fn, args, want):
    rules = dict(jshd.DEFAULT_RULES)
    ref = getattr(jshd, fn)(*args, FAKE, rules)
    got = getattr(shd, fn)(*args, FAKE, dict(shd.DEFAULT_RULES))
    assert tuple(ref) == want
    assert tuple(got) == want and isinstance(got, shd.PartitionSpec)


def test_default_rules_are_the_reference():
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert shd._PARAM_RULES == jshd._PARAM_RULES


@pytest.mark.parametrize("side", ["reference", "port"])
def test_constrain_is_noop_without_mesh(side):
    if side == "reference":
        x = jnp.ones((4, 4))
        assert jshd.constrain(x, "batch", None) is x
    else:
        x = torch.ones(4, 4)
        assert shd.constrain(x, "batch", None) is x
        with shd.activation_rules(None):
            assert shd.constrain(x, "batch", None) is x


def test_activation_rules_drop_missing_axes_and_restore():
    mesh = _stub(MESHES["data16_model16"])
    with shd.activation_rules(mesh, {"fsdp": ("pod", "data")}):
        ctx = shd.current()
        assert ctx.rules["batch"] == ("data",)
        assert ctx.rules["fsdp"] == ("data",)
        with shd.activation_rules(None):
            assert shd.current() is None
        assert shd.current() is ctx
    assert shd.current() is None


class _Mesh:
    """What ``placements`` reads of a DeviceMesh."""

    def __init__(self, **shape):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


@pytest.mark.parametrize("spec,want", [
    ((("pod", "data"), None), (Shard(0), Shard(0), Replicate())),
    ((None, "data", "model"), (Replicate(), Shard(1), Shard(2))),
    (("model", "data"), (Replicate(), Shard(1), Shard(0))),
    ((("pod", "data", "model"), None), (Shard(0), Shard(0), Shard(0))),
    ((None, None), (Replicate(), Replicate(), Replicate())),
])
def test_placements_invert_the_spec(spec, want):
    mesh = _Mesh(pod=2, data=16, model=16)
    assert shd.mesh_shape(mesh) == {"pod": 2, "data": 16, "model": 16}
    assert shd.placements(shd.P(*spec), mesh) == want


def test_placements_refuse_an_order_dtensor_cannot_split_in():
    with pytest.raises(ValueError, match="mesh's order"):
        shd.placements(shd.P(("data", "pod")), _Mesh(pod=2, data=16))
