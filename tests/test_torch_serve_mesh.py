"""Serving under a mesh, and the input specs.

``make_prefill_fn`` + ``make_decode_fn`` and ``ServeEngine(mesh=...)`` on
a (2, 2) mesh of gloo ranks (parameters placed by ``shard_module``, caches
as the reference's dry run places them) give the unsharded logits within
rel 1e-5 (float32 compute and caches) for a prefill and 4 greedy decode
steps, and the same generated tokens: jag-surrogate, deepseek-v2-lite-16b
(MLA, MoE with every expert routed), rwkv6-3b, zamba2-1.2b, whisper-tiny,
llama-3.2-vision-11b and phi4-mini-3.8b.  whisper's batch of 2 does not
split over its (data, model) batch axes, so its self and cross K/V caches
split along their positions (``kv_seq``), as do phi4's (3 KV heads on a
2-way ``model`` axis) and deepseek's latent cache: the decode softmax runs
over a split dim, each rank's partial rows merged.

``registry.input_specs`` (abstract and concrete), ``applicable_shapes``
and ``base.shape_applicable`` give the reference's shapes and dtypes for
all eleven archs and four workload shapes.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.configs import base as pbase
from repro_torch.configs import registry as preg

REL = 1e-5
CASES = [("jag", "jag-surrogate", {}),
         ("deepseek", "deepseek-v2-lite-16b", {"top_k": 8}),
         ("rwkv6", "rwkv6-3b", {}),
         ("zamba2", "zamba2-1.2b", {}),
         ("whisper", "whisper-tiny", {}),
         ("vision", "llama-3.2-vision-11b", {}),
         ("phi4", "phi4-mini-3.8b", {})]
STEPS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    _torch_dist.spawn(_torch_dist.serve_mesh_rank, 4, str(tmp), 420, CASES,
                      (2, 2), 2, 11, STEPS)
    return tmp, json.loads((tmp / "serve.json").read_text())


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_mesh_serving_equals_unsharded(runs, label):
    tmp, out = runs
    want = np.load(tmp / f"{label}_plain.npz")
    got = np.load(tmp / f"{label}_mesh.npz")
    assert len(want.files) == STEPS + 1
    for k in want.files:
        rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert rel < REL, (k, rel)
    res = out[label]
    assert res["mesh"]["tokens"] == res["plain"]["tokens"]
    assert len(res["plain"]["tokens"][0]) == STEPS + 1
    assert res["mesh"]["caches"] and not res["plain"]["caches"]


def test_caches_split_over_positions_and_heads(runs):
    _, out = runs

    def placed(label, leaf):
        return [c.split(":", 1)[1] for c in out[label]["mesh"]["caches"]
                if c.startswith(leaf + ":")]
    seq = "S0,S1"
    for label, leaf in (("whisper", "k"), ("whisper", "xk"), ("phi4", "k"),
                        ("deepseek", "latent")):
        assert placed(label, leaf) == [seq], (label, leaf)
    assert placed("jag", "k") == ["S0,S2"]
    assert placed("rwkv6", "state") == [seq]
    assert placed("zamba2", "conv") == ["S0,S2"]


_DT = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("arch", sorted(preg.ARCHS))
def test_input_specs_are_the_reference(arch):
    jcfg, pcfg = jreg.get_config(arch), preg.get_config(arch)
    assert [s.name for s in preg.applicable_shapes(arch)] == \
        [s.name for s in jreg.applicable_shapes(arch)]
    for name in pbase.SHAPES:
        assert pbase.shape_applicable(arch, name, pcfg.family) == \
            jbase.shape_applicable(arch, name, jcfg.family)
        assert pbase.SHAPES[name] == pbase.ShapeConfig(
            **vars(jbase.SHAPES[name]))
        want = jreg.input_specs(jcfg, jbase.SHAPES[name], abstract=True)
        got = preg.input_specs(pcfg, pbase.SHAPES[name], abstract=True)
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(v.shape)
            assert got[k].dtype == _DT[v.dtype.type], (k, got[k].dtype)


def test_concrete_inputs_are_seeded_and_in_range():
    cfg = preg.reduced_config("llama-3.2-vision-11b")
    shape = pbase.ShapeConfig("t", "train", 16, 2)
    a = preg.input_specs(cfg, shape, abstract=False,
                         gen=torch.Generator().manual_seed(3))
    b = preg.input_specs(cfg, shape, abstract=False,
                         gen=torch.Generator().manual_seed(3))
    assert list(a) == ["tokens", "labels", "img_embed"]
    for k in a:
        assert torch.equal(a[k], b[k])
    assert a["img_embed"].dtype == torch.bfloat16
    assert a["tokens"].dtype == torch.int32
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < cfg.vocab_size
    assert tuple(a["img_embed"].shape) == (2, cfg.n_img_tokens, cfg.d_vision)
