"""Layers, LM stack, serving engine and entry point of the PyTorch port
against the JAX reference, on the CPU at reduced sizes.

Inputs and weights are made on the JAX side (or with numpy from a seed) and
handed over as numpy arrays; ``convert.params_from_jax`` loads the weights.
float32 compute agrees to rel 1e-4; bf16 compute to rel 5e-2, since bf16
rounds at different places in the two frameworks.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.configs.base import LayerSpec
from repro_torch.launch.serve import llm_serve_main
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine

REL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCHS = ["jag-surrogate", "granite-3-8b"]


def rel_err(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def configs(arch, dtype):
    jc = jreg.reduced_config(arch).replace(compute_dtype=dtype)
    pc = preg.reduced_config(arch).replace(compute_dtype=dtype)
    return jc, pc


def to_numpy(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def load(module, np_dict):
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in np_dict.items()})
    return module


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_field_for_field(arch):
    assert dataclasses.asdict(preg.get_config(arch)) == \
        dataclasses.asdict(jreg.get_config(arch))
    assert dataclasses.asdict(preg.reduced_config(arch)) == \
        dataclasses.asdict(jreg.reduced_config(arch))


def test_unported_archs_and_kinds_raise():
    with pytest.raises(KeyError, match="not ported"):
        preg.get_config("zamba2-1.2b")
    cfg = preg.reduced_config("jag-surrogate")
    for bad in (cfg.replace(superblock=(LayerSpec(kind="mamba2"),)),
                cfg.replace(superblock=(LayerSpec(mlp="moe"),)),
                cfg.replace(sandwich_norm=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            lm.init_params(bad, torch.Generator().manual_seed(0), "cpu")


# ---------------------------------------------------------------------------
# (b) layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rope_glu(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 4, 32), dtype=np.float32)
    scale = rng.standard_normal(32, dtype=np.float32) * 0.1
    jx, tx = jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])
    norm = load(L.init_rmsnorm(32, torch.float32, "cpu"), {"scale": scale})
    assert rel_err(L.rmsnorm(norm, tx, 1e-6),
                   jL.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6)) < REL[dtype]

    pos = np.arange(5, 17)
    assert rel_err(L.rope(tx, torch.from_numpy(pos), 10000.0),
                   jL.rope(jx, jnp.asarray(pos), 10000.0)) < REL[dtype]

    jp = to_numpy(jL.init_glu_mlp(jax.random.PRNGKey(1), 32, 64, jnp.float32))
    mlp = load(L.init_glu_mlp(torch.Generator().manual_seed(0), 32, 64,
                              torch.float32, "cpu"), jp)
    h = rng.standard_normal((2, 12, 32), dtype=np.float32)
    want = jL.glu_mlp(jax.tree.map(jnp.asarray, jp),
                      jnp.asarray(h).astype(JDT[dtype]), JDT[dtype])
    got = L.glu_mlp(mlp, torch.from_numpy(h).to(TDT[dtype]), TDT[dtype])
    assert rel_err(got, want) < REL[dtype]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_layer(arch, dtype, qk_norm):
    jc, pc = configs(arch, dtype)
    jc, pc = jc.replace(qk_norm=qk_norm), pc.replace(qk_norm=qk_norm)
    jp = to_numpy(jL.init_attention(jax.random.PRNGKey(2), jc))
    if qk_norm:  # nonzero norm scales, so the (1 + scale) form is exercised
        jp["qnorm"]["scale"] += 0.1
        jp["knorm"]["scale"] -= 0.1
    flat = {f"{k}.scale" if isinstance(v, dict) else k:
            (v["scale"] if isinstance(v, dict) else v) for k, v in jp.items()}
    att = load(L.init_attention(torch.Generator().manual_seed(0), pc, "cpu"), flat)
    x = np.random.default_rng(3).standard_normal((2, 40, pc.d_model),
                                                 dtype=np.float32)
    spec = pc.superblock[0]
    want, _ = jL.attention(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jc,
                           jc.superblock[0], positions=jnp.arange(40))
    got, _ = L.attention(att, torch.from_numpy(x), pc, spec,
                         positions=torch.arange(40))
    assert rel_err(got, want) < REL[dtype]


# ---------------------------------------------------------------------------
# (c) the LM stack through params_from_jax
# ---------------------------------------------------------------------------

def pair(arch, dtype, seed=0):
    jc, pc = configs(arch, dtype)
    jparams = jlm.init_params(jax.random.PRNGKey(seed), jc)
    model = convert.params_from_jax(to_numpy(jparams), pc, "cpu")
    return jc, pc, jparams, model


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_logits(arch, dtype):
    jc, pc, jparams, model = pair(arch, dtype)
    toks = np.random.default_rng(4).integers(0, pc.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jlm.forward_train(jparams, jnp.asarray(toks), jc)
    with torch.no_grad():
        got, aux = lm.forward_train(model, torch.from_numpy(toks), pc)
        assert rel_err(model(torch.from_numpy(toks)), want) < REL[dtype]
    assert got.shape == (2, 24, pc.vocab_size)
    assert aux == lm.ZERO_AUX
    assert rel_err(got, want) < REL[dtype]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("extra", [4, 0, -5])  # cache longer / full / rolled
def test_prefill_then_decode(arch, dtype, extra):
    jc, pc, jparams, model = pair(arch, dtype, seed=1)
    S = 20
    toks = np.random.default_rng(5).integers(0, pc.vocab_size, (2, S)).astype(np.int32)
    jcache_dt = JDT[dtype]
    jl, jcaches = jlm.prefill(jparams, jnp.asarray(toks), jc, max_len=S + extra,
                              cache_dtype=jcache_dt)
    with torch.no_grad():
        tl, tcaches = lm.prefill(model, torch.from_numpy(toks), pc,
                                 max_len=S + extra, cache_dtype=TDT[dtype])
        assert rel_err(tl, jl) < REL[dtype]
        for c_t, c_j in zip(tcaches["layers"], _unstack_caches(jcaches, jc)):
            assert rel_err(c_t["k"], c_j["k"]) < REL[dtype]
            assert rel_err(c_t["v"], c_j["v"]) < REL[dtype]
        assert tcaches["pos"] == S
        for step in range(2):
            nxt = np.argmax(np.asarray(jl, np.float32).reshape(2, -1), -1)
            nxt = nxt[:, None].astype(np.int32)
            jl, jcaches = jlm.decode_step(jparams, jnp.asarray(nxt), jcaches, jc)
            tl, tcaches = lm.decode_step(model, torch.from_numpy(nxt), tcaches, pc)
            assert tl.shape == (2, pc.vocab_size)
            assert rel_err(tl, jl) < REL[dtype], step


def _unstack_caches(jcaches, cfg):
    out = []
    for r in range(cfg.n_repeat):
        for blk in jcaches["blocks"]:
            out.append({k: np.asarray(v[r], np.float32) for k, v in blk.items()})
    return out


def test_convert_rejects_unported_params():
    jc, pc = configs("jag-surrogate", "float32")
    tree = to_numpy(jlm.init_params(jax.random.PRNGKey(0), jc))
    tree["encoder"] = {}
    with pytest.raises(NotImplementedError, match="encoder"):
        convert.params_from_jax(tree, pc, "cpu")


def test_untied_head_converts():
    jc, pc = configs("jag-surrogate", "float32")
    jc, pc = jc.replace(tie_embeddings=False), pc.replace(tie_embeddings=False)
    jparams = jlm.init_params(jax.random.PRNGKey(3), jc)
    model = convert.params_from_jax(to_numpy(jparams), pc, "cpu")
    toks = np.random.default_rng(6).integers(0, pc.vocab_size, (1, 9)).astype(np.int32)
    want, _ = jlm.forward_train(jparams, jnp.asarray(toks), jc)
    with torch.no_grad():
        got, _ = lm.forward_train(model, torch.from_numpy(toks), pc)
    assert rel_err(got, want) < REL["float32"]


# ---------------------------------------------------------------------------
# (d) serving engine, (e) entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_reference(arch):
    jc, pc, jparams, model = pair(arch, "float32", seed=2)
    toks = np.random.default_rng(7).integers(0, pc.vocab_size, (3, 16)).astype(np.int32)
    jeng = JaxServeEngine(jc, jparams, max_len=32, cache_dtype=jnp.float32)
    want = np.asarray(jeng.generate(jnp.asarray(toks), 6))
    eng = ServeEngine(pc, model, max_len=32, cache_dtype=torch.float32)
    got = eng.generate(torch.from_numpy(toks), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(eng.stats) == set(jeng.stats)
    assert eng.stats["prefill_tokens"] == 3 * 16
    assert eng.stats["decode_tokens"] == 3 * 5


def test_llm_serve_main_on_cpu(capsys):
    assert llm_serve_main(["--arch", "jag-surrogate", "--device", "cpu",
                           "--prompt-len", "8", "--new-tokens", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "jag-surrogate"
    assert out["generated_shape"] == [4, 2]
    assert out["device"] == "cpu"
    assert out["flash_launches"] == 0
    assert out["prefill_tok_per_s"] > 0 and out["decode_tok_per_s"] > 0
