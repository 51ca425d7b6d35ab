"""Layers, the RWKV6 and Mamba2 blocks, LM stack, serving engine and entry
point of the PyTorch port against the JAX reference, on the CPU at reduced
sizes.

Inputs and weights are made on the JAX side (or with numpy from a seed) and
handed over as numpy arrays; ``convert.params_from_jax`` loads the weights.
whisper-tiny and llama-3.2-vision-11b get their extras (``enc_embed`` /
``img_embed``) from a numpy seed, and every llama-vision ``xgate`` a value
from U(0.5, 1.5) (``pair``).  tests/test_torch_encdec.py imports the
helpers.
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
from repro.models import rwkv as jrw
from repro.models import ssm as jssm
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.configs.base import LayerSpec
from repro_torch.launch.serve import llm_serve_main
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import rwkv as RW
from repro_torch.models import ssm as SSM
from repro_torch.serve.engine import ServeEngine, extra_shapes

REL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCHS = ["jag-surrogate", "granite-3-8b", "rwkv6-3b", "zamba2-1.2b",
         "phi4-mini-3.8b", "gemma2-27b", "deepseek-v2-lite-16b", "arctic-480b",
         "whisper-tiny", "llama-3.2-vision-11b", "starcoder2-15b"]
# MLA caches are max_len long and never roll (the reference's
# dynamic_update_slice cannot write a prompt longer than its cache)
MLA_ARCHS = ("deepseek-v2-lite-16b",)


def rel_err(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def configs(arch, dtype):
    """Reduced configs of both packages in ``dtype`` compute.  In bf16 an
    MoE model routes every token to all its experts (top_k = n_experts, so
    nothing is dropped): the top-k choice is discontinuous, and bf16 router
    logits that differ by one rounding between the frameworks pick other
    experts (reduced deepseek-v2-lite: 1-4 tokens a layer, logits rel
    0.15-0.32).  The real top-k, capacity and drops are held in float32 here
    and in bf16 on equal inputs in test_torch_variants.py."""
    over = dict(compute_dtype=dtype)
    if dtype == "bfloat16" and jreg.get_config(arch).n_experts:
        over["top_k"] = jreg.reduced_config(arch).n_experts
    jc = jreg.reduced_config(arch).replace(**over)
    pc = preg.reduced_config(arch).replace(**over)
    return jc, pc


def to_numpy(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def load(module, np_dict):
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in np_dict.items()})
    return module


def flat(tree, prefix=""):
    """{'ln_x': {'scale': a}} -> {'ln_x.scale': a}."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_field_for_field(arch):
    assert dataclasses.asdict(preg.get_config(arch)) == \
        dataclasses.asdict(jreg.get_config(arch))
    assert dataclasses.asdict(preg.reduced_config(arch)) == \
        dataclasses.asdict(jreg.reduced_config(arch))


def test_registry_has_the_reference_archs_and_unknown_kinds_raise():
    assert preg.ARCHS.keys() == jreg.ARCHS.keys()
    with pytest.raises(KeyError, match="unknown arch"):
        preg.get_config("no-such-arch")
    cfg = preg.reduced_config("jag-surrogate")
    for bad, what in ((cfg.replace(superblock=(LayerSpec(kind="conv"),)),
                       "layer kind 'conv'"),
                      (cfg.replace(superblock=(LayerSpec(mlp="swiglu"),)),
                       "MLP 'swiglu'")):
        with pytest.raises(ValueError, match=f"unknown {what}"):
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
# (b2) the RWKV6 and Mamba2 blocks
# ---------------------------------------------------------------------------

def _rwkv_pair(dtype):
    jc, pc = configs("rwkv6-3b", dtype)
    jp = to_numpy(jrw.init_rwkv6(jax.random.PRNGKey(5), jc))
    jp["w_lora_b"] = jp["w_lora_b"] * 30.0  # a decay that varies with the data
    jp["mix_k"] = jp["mix_k"] - 0.3  # mixes that differ per projection
    mod = load(RW.init_rwkv6(torch.Generator().manual_seed(0), pc, "cpu"), flat(jp))
    return jc, pc, jax.tree.map(jnp.asarray, jp), mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_cache", [False, True])
def test_rwkv6_time_and_channel_mix(dtype, with_cache):
    jc, pc, jp, mod = _rwkv_pair(dtype)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 21, pc.d_model), dtype=np.float32)
    jcache = tcache = None
    if with_cache:  # a carried token shift and state, as after a prefill
        st = rng.standard_normal((2, pc.d_model // pc.rwkv_head_dim,
                                  pc.rwkv_head_dim, pc.rwkv_head_dim),
                                 dtype=np.float32) * 0.1
        sh = rng.standard_normal((2, 1, pc.d_model), dtype=np.float32)
        jcache = {"shift_t": jnp.asarray(sh), "shift_c": jnp.asarray(sh),
                  "state": jnp.asarray(st)}
        tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    for S in (21, 1):  # prefill through the scan, then one decode step
        want, jnc = jrw.rwkv6_time_mix(jp, jnp.asarray(x[:, :S]), jc, cache=jcache)
        with torch.no_grad():
            got, tnc = RW.rwkv6_time_mix(mod, torch.from_numpy(x[:, :S]), pc,
                                         cache=tcache)
        assert rel_err(got, want) < REL[dtype]
        if with_cache:
            for key in ("shift_t", "state"):
                assert rel_err(tnc[key], jnc[key]) < REL[dtype], (S, key)
        want, _ = jrw.rwkv6_channel_mix(jp, jnp.asarray(x[:, :S]), jc, cache=jcache)
        with torch.no_grad():
            got, _ = RW.rwkv6_channel_mix(mod, torch.from_numpy(x[:, :S]), pc,
                                          cache=tcache)
        assert rel_err(got, want) < REL[dtype]
        if not with_cache:
            break


def test_causal_conv():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 13, 24), dtype=np.float32)
    w = rng.standard_normal((4, 24), dtype=np.float32)
    state = rng.standard_normal((2, 3, 24), dtype=np.float32)
    for st in (None, state):
        want, wst = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                      None if st is None else jnp.asarray(st))
        got, gst = SSM._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                    None if st is None else torch.from_numpy(st))
        assert rel_err(got, want) < 1e-6
        assert rel_err(gst, wst) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block(dtype):
    jc, pc = configs("zamba2-1.2b", dtype)
    jp = to_numpy(jssm.init_mamba2(jax.random.PRNGKey(6), jc))
    rng = np.random.default_rng(10)
    jp["A_log"] = rng.standard_normal(jp["A_log"].shape).astype(np.float32) * 0.5
    jp["dt_bias"] = rng.standard_normal(jp["dt_bias"].shape).astype(np.float32) * 0.5
    mod = load(SSM.init_mamba2(torch.Generator().manual_seed(0), pc, "cpu"), flat(jp))
    jp = jax.tree.map(jnp.asarray, jp)
    x = rng.standard_normal((2, 45, pc.d_model), dtype=np.float32)  # ragged
    jcache = jssm.init_mamba2_cache(jc, 2, JDT[dtype])
    tcache = SSM.init_mamba2_cache(pc, 2, TDT[dtype], "cpu")
    for S in (44, 1):  # prefill, then one decode step on the carried state
        xs = x[:, :S] if S > 1 else x[:, 44:]
        want, jcache = jssm.mamba2_block(jp, jnp.asarray(xs), jc, cache=jcache)
        with torch.no_grad():
            got, tcache = SSM.mamba2_block(mod, torch.from_numpy(xs), pc,
                                           cache=tcache)
        assert rel_err(got, want) < REL[dtype], S
        for key in ("conv", "ssm"):
            assert rel_err(tcache[key], jcache[key]) < REL[dtype], (S, key)


# ---------------------------------------------------------------------------
# (c) the LM stack through params_from_jax
# ---------------------------------------------------------------------------

def pair(arch, dtype, seed=0):
    """Both packages' reduced models from the reference's init.  Every
    llama-vision ``xgate`` (0 at init, where tanh(0) = 0 hides its
    cross-attention) is drawn from U(0.5, 1.5)."""
    jc, pc = configs(arch, dtype)
    tree = to_numpy(jlm.init_params(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(100 + seed)
    for blk in tree["blocks"]:
        if "xgate" in blk:
            blk["xgate"] = rng.uniform(0.5, 1.5, blk["xgate"].shape).astype(
                np.float32)
    model = convert.params_from_jax(tree, pc, "cpu")
    return jc, pc, jax.tree.map(jnp.asarray, tree), model


def extras(cfg, batch, seed=1):
    """whisper's ``enc_embed`` and llama-vision's ``img_embed`` where the
    model reads them, N(0, 1) from ``seed``: (for JAX, for the port)."""
    rng = np.random.default_rng(seed)
    ex = {k: rng.standard_normal(shape, dtype=np.float32)
          for k, shape in extra_shapes(cfg, batch).items()}
    return ({k: jnp.asarray(v) for k, v in ex.items()},
            {k: torch.from_numpy(v) for k, v in ex.items()})


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_logits(arch, dtype):
    jc, pc, jparams, model = pair(arch, dtype)
    toks = np.random.default_rng(4).integers(0, pc.vocab_size, (2, 24)).astype(np.int32)
    jex, tex = extras(pc, 2)
    want, want_aux = jlm.forward_train(jparams, jnp.asarray(toks), jc, jex)
    with torch.no_grad():
        got, aux = lm.forward_train(model, torch.from_numpy(toks), pc, tex)
        assert rel_err(model(torch.from_numpy(toks), tex), want) < REL[dtype]
    assert got.shape == (2, 24, pc.vocab_size)
    if pc.n_experts:
        for key, val in want_aux.items():
            assert rel_err(aux[key], val) < REL[dtype], key
    else:
        assert aux == lm.ZERO_AUX
    assert rel_err(got, want) < REL[dtype]


@pytest.mark.parametrize("arch,extra", [  # cache longer / full / rolled
    (arch, extra) for arch in ARCHS for extra in (4, 0, -5)
    if not (arch in MLA_ARCHS and extra < 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode(arch, dtype, extra):
    jc, pc, jparams, model = pair(arch, dtype, seed=1)
    S = 20
    toks = np.random.default_rng(5).integers(0, pc.vocab_size, (2, S)).astype(np.int32)
    jcache_dt = JDT[dtype]
    jex, tex = extras(pc, 2, seed=2)
    jl, jcaches = jlm.prefill(jparams, jnp.asarray(toks), jc, max_len=S + extra,
                              extra=jex, cache_dtype=jcache_dt)
    with torch.no_grad():
        tl, tcaches = lm.prefill(model, torch.from_numpy(toks), pc,
                                 max_len=S + extra, extra=tex,
                                 cache_dtype=TDT[dtype])
        assert rel_err(tl, jl) < REL[dtype]
        for c_t, c_j in zip(tcaches["layers"], _unstack_caches(jcaches, jc)):
            assert set(c_t) == set(c_j)
            for key in c_j:
                # bf16 rounding drifts through a deep recurrent stack; the
                # block tests hold each recurrent cache at the bf16 bar on
                # equal inputs, so here only K/V are held in bf16
                if dtype == "float32" or key in ("k", "v"):
                    assert rel_err(c_t[key], c_j[key]) < REL[dtype], key
        assert tcaches["pos"] == S
        for step in range(2):
            nxt = np.argmax(np.asarray(jl, np.float32).reshape(2, -1), -1)
            nxt = nxt[:, None].astype(np.int32)
            jl, jcaches = jlm.decode_step(jparams, jnp.asarray(nxt), jcaches, jc)
            tl, tcaches = lm.decode_step(model, torch.from_numpy(nxt), tcaches, pc)
            assert tl.shape == (2, pc.vocab_size)
            assert rel_err(tl, jl) < REL[dtype], step


def _unstack_caches(jcaches, cfg):
    out = [{k: np.asarray(v, np.float32) for k, v in c.items()}
           for c in jcaches["prologue"]]
    for r in range(cfg.n_repeat):
        for blk in jcaches["blocks"]:
            out.append({k: np.asarray(v[r], np.float32) for k, v in blk.items()})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_prompt_longer_than_decode_window(dtype):
    """A 40-token prompt against the reduced decode window of 32: the shared
    block's K/V caches roll at prefill and keep rolling in decode."""
    jc, pc, jparams, model = pair("zamba2-1.2b", dtype, seed=3)
    assert pc.decode_window == 32
    toks = np.random.default_rng(11).integers(0, pc.vocab_size, (2, 40)).astype(np.int32)
    jl, jcaches = jlm.prefill(jparams, jnp.asarray(toks), jc, max_len=48,
                              cache_dtype=JDT[dtype])
    with torch.no_grad():
        tl, tcaches = lm.prefill(model, torch.from_numpy(toks), pc, max_len=48,
                                 cache_dtype=TDT[dtype])
        assert rel_err(tl, jl) < REL[dtype]
        shared = [c for c, spec in zip(tcaches["layers"], pc.plan)
                  if spec.kind == "shared_attn"]
        assert len(shared) == pc.n_repeat
        assert all(c["k"].shape[1] == 32 for c in shared)
        for step in range(2):
            nxt = np.argmax(np.asarray(jl, np.float32).reshape(2, -1), -1)
            nxt = nxt[:, None].astype(np.int32)
            jl, jcaches = jlm.decode_step(jparams, jnp.asarray(nxt), jcaches, jc)
            tl, tcaches = lm.decode_step(model, torch.from_numpy(nxt), tcaches, pc)
            assert rel_err(tl, jl) < REL[dtype], step


def test_convert_rejects_unported_params():
    jc, pc = configs("jag-surrogate", "float32")
    tree = to_numpy(jlm.init_params(jax.random.PRNGKey(0), jc))
    tree["vision_tower"] = {}
    with pytest.raises(NotImplementedError, match="vision_tower"):
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
    jex, tex = extras(pc, 3, seed=3)
    jeng = JaxServeEngine(jc, jparams, max_len=32, cache_dtype=jnp.float32)
    want = np.asarray(jeng.generate(jnp.asarray(toks), 6, extra=jex))
    eng = ServeEngine(pc, model, max_len=32, cache_dtype=torch.float32)
    got = eng.generate(torch.from_numpy(toks), 6, extra=tex)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(eng.stats) == set(jeng.stats)
    assert eng.stats["prefill_tokens"] == 3 * 16
    assert eng.stats["decode_tokens"] == 3 * 5


@pytest.mark.parametrize("arch", ["jag-surrogate", "rwkv6-3b", "zamba2-1.2b",
                                  "phi4-mini-3.8b", "gemma2-27b",
                                  "deepseek-v2-lite-16b", "arctic-480b"])
def test_llm_serve_main_on_cpu(capsys, arch):
    assert llm_serve_main(["--arch", arch, "--device", "cpu",
                           "--prompt-len", "8", "--new-tokens", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == arch
    assert out["generated_shape"] == [4, 2]
    assert out["device"] == "cpu"
    # the CPU runs the plain versions: no kernel launches
    assert out["flash_launches"] == out["wkv6_launches"] == out["ssd_launches"] == 0
    assert out["prefill_tok_per_s"] > 0 and out["decode_tok_per_s"] > 0
