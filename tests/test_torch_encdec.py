"""The encoder and cross-attention path of the PyTorch port against the JAX
reference, on the CPU at reduced sizes: the GELU MLP, ``_cross_attn`` at
prefill and decode, whisper's encoder, and whisper-tiny,
llama-3.2-vision-11b and starcoder2-15b end to end (training forward, loss,
prefill, decode, the serving engine, the entry points).

Weights come from the reference's ``init_params`` (through numpy and
``convert.params_from_jax``), inputs and extras from a numpy seed.  Every
llama-vision ``xgate`` is set to a value drawn from U(0.5, 1.5) first: at
its init of 0, tanh(0) = 0 and a gated cross-attention layer adds nothing,
so a wrong cross-attention would pass unseen.  The JAX side runs with
``use_pallas="auto"``, its plain path on the CPU.  float32 compute agrees to
rel 1e-4; bf16 compute to rel 5e-2 (bf16 rounds at different places in the
two frameworks).
"""
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
from repro_torch.configs import registry as preg
from repro_torch.launch import train as launch_train
from repro_torch.launch.serve import llm_serve_main
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine
from test_torch_lm import JDT, REL, TDT, extras, pair, rel_err, to_numpy

ARCHS = ["whisper-tiny", "llama-3.2-vision-11b", "starcoder2-15b"]
DTYPES = ["float32", "bfloat16"]


def configs(arch, dtype, **over):
    return (jreg.reduced_config(arch).replace(compute_dtype=dtype, **over),
            preg.reduced_config(arch).replace(compute_dtype=dtype, **over))


def attention_pair(jc, pc, seed):
    jp = to_numpy(jL.init_attention(jax.random.PRNGKey(seed), jc))
    att = L.init_attention(torch.Generator().manual_seed(0), pc, "cpu")
    att.load_state_dict({k: torch.from_numpy(v) for k, v in jp.items()})
    return jax.tree.map(jnp.asarray, jp), att


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_mlp(dtype):
    jp = to_numpy(jL.init_gelu_mlp(jax.random.PRNGKey(1), 32, 64, jnp.float32))
    mlp = L.init_gelu_mlp(torch.Generator().manual_seed(0), 32, 64,
                          torch.float32, "cpu")
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in jp.items()})
    # wide inputs, so the tanh form's difference from erf's (~1e-3) shows
    h = np.random.default_rng(0).standard_normal((2, 12, 32),
                                                 dtype=np.float32) * 3
    want = jL.gelu_mlp(jax.tree.map(jnp.asarray, jp),
                       jnp.asarray(h).astype(JDT[dtype]), JDT[dtype])
    got = L.gelu_mlp(mlp, torch.from_numpy(h).to(TDT[dtype]), TDT[dtype])
    assert got.dtype == TDT[dtype]
    assert rel_err(got, want) < REL[dtype]


# (compute dtype, cache dtype): the last is the rounding-point case, where
# prefill attends over fresh float32 K/V and decode over the bf16 cache
CROSS_DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
                ("float32", "bfloat16")]


@pytest.mark.parametrize("dtype,cache_dtype", CROSS_DTYPES)
@pytest.mark.parametrize("S", [11, 1])
def test_cross_attn_prefill_then_decode(dtype, cache_dtype, S):
    """``_cross_attn`` with a cache: at prefill (``enc`` given, S query rows
    against T = 16 states) it fills xk / xv; then two decode steps (``enc``
    None) read them back.  GQA 4:2."""
    jc, pc = configs("llama-3.2-vision-11b", dtype, n_kv_heads=2)
    jp, att = attention_pair(jc, pc, seed=5)
    rng = np.random.default_rng(6)
    enc = rng.standard_normal((2, 16, pc.d_model), dtype=np.float32)
    spec = pc.superblock[0]
    assert spec.kind == "xattn"
    jcache = jlm.init_layer_cache(jc, jc.superblock[0], 2, 24, JDT[cache_dtype])
    tcache = lm.init_layer_cache(pc, spec, 2, 24, TDT[cache_dtype], "cpu")
    assert set(tcache) == set(jcache) == {"xk", "xv"}
    for step, (n, e) in enumerate(((S, enc), (1, None), (1, None))):
        h = rng.standard_normal((2, n, pc.d_model), dtype=np.float32)
        want, jcache = jlm._cross_attn(
            jp, jnp.asarray(h), jc, jc.superblock[0],
            None if e is None else jnp.asarray(e), jcache)
        with torch.no_grad():
            got, tcache = lm._cross_attn(
                att, torch.from_numpy(h), pc,
                None if e is None else torch.from_numpy(e), tcache)
        assert rel_err(got, want) < REL[dtype], step
        for key in ("xk", "xv"):
            assert tcache[key].dtype == TDT[cache_dtype]
            assert rel_err(tcache[key], jcache[key]) < REL[dtype], key


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attn_without_cache(dtype):
    """The training form: no cache, K/V from ``enc``; S != T and S = 1."""
    jc, pc = configs("whisper-tiny", dtype)
    jp, att = attention_pair(jc, pc, seed=7)
    rng = np.random.default_rng(8)
    enc = rng.standard_normal((3, pc.enc_len, pc.d_model), dtype=np.float32)
    for S in (9, 1):
        h = rng.standard_normal((3, S, pc.d_model), dtype=np.float32)
        want, jc_ = jlm._cross_attn(jp, jnp.asarray(h), jc, jc.superblock[0],
                                    jnp.asarray(enc), None)
        got, tc_ = lm._cross_attn(att, torch.from_numpy(h), pc,
                                  torch.from_numpy(enc), None)
        assert jc_ is None and tc_ is None
        assert rel_err(got, want) < REL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode(dtype):
    """whisper's encoder: non-causal GELU-MLP layers at positions
    0..enc_len-1, then its final norm."""
    jc, pc, jparams, model = pair("whisper-tiny", dtype, seed=4)
    jex, tex = extras(pc, 2)
    want = jlm._encode(jparams, jc, jex["enc_embed"])
    with torch.no_grad():
        got = lm._encode(model, pc, tex["enc_embed"])
    assert got.shape == (2, pc.enc_len, pc.d_model)
    assert got.dtype == TDT[dtype]
    assert rel_err(got, want) < REL[dtype]


def test_encoder_is_not_causal():
    """Changing the last frame changes the encoder's first output row."""
    _, pc, _, model = pair("whisper-tiny", "float32")
    enc = extras(pc, 1)[1]["enc_embed"]
    moved = enc.clone()
    moved[:, -1] += 1.0
    with torch.no_grad():
        a = lm._encode(model, pc, enc)
        b = lm._encode(model, pc, moved)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# the three archs end to end
# ---------------------------------------------------------------------------

def test_params_convert_with_reference_names():
    """The reference's leaves land on the port's parameters of the same
    names (``strict=True`` holds the two sets equal), the encoder's stacked
    blocks and the 0-d xgate included."""
    for arch, keys in (("whisper-tiny", ("encoder.blocks.1.mlp.wi",
                                         "encoder.final_norm.scale",
                                         "layers.0.xnorm.scale",
                                         "layers.1.xattn.wq",
                                         "layers.1.mlp.wo")),
                       ("llama-3.2-vision-11b", ("w_img", "layers.5.xgate",
                                                 "layers.6.mlp.wg")),
                       ("starcoder2-15b", ("lm_head", "layers.1.mlp.wi"))):
        sd = pair(arch, "float32")[3].state_dict()
        for key in keys:
            assert key in sd, (arch, key)
    _, pc, _, model = pair("llama-3.2-vision-11b", "float32")
    gates = [p.xgate.item() for p, s in zip(model.layers, pc.plan)
             if s.kind == "xattn"]
    assert len(gates) == pc.n_repeat and all(0.5 <= g <= 1.5 for g in gates)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_train_and_loss(arch, dtype):
    jc, pc, jparams, model = pair(arch, dtype, seed=1)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, pc.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(-1, pc.vocab_size, (2, 24)).astype(np.int32)
    jex, tex = extras(pc, 2)
    want, _ = jlm.forward_train(jparams, jnp.asarray(toks), jc, extra=jex)
    jloss, jm = jlm.loss_fn(jparams, {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(labels), **jex}, jc)
    with torch.no_grad():
        got, aux = lm.forward_train(model, torch.from_numpy(toks), pc,
                                    extra=tex)
        assert rel_err(model(torch.from_numpy(toks), tex), want) < REL[dtype]
        loss, m = lm.loss_fn(model, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labels),
                                     **tex}, pc)
    assert got.shape == (2, 24, pc.vocab_size)
    assert aux == lm.ZERO_AUX
    assert rel_err(got, want) < REL[dtype]
    assert rel_err(loss, jloss) < REL[dtype]
    assert float(m["ntokens"]) == float(jm["ntokens"])


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_loss_reads_the_extras(arch):
    """The extras reach the loss: other embeddings, another loss."""
    _, pc, _, model = pair(arch, "float32")
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, pc.vocab_size, (2, 12)).astype(np.int64))
    losses = []
    with torch.no_grad():
        for seed in (1, 2):
            _, tex = extras(pc, 2, seed=seed)
            losses.append(float(lm.loss_fn(
                model, {"tokens": toks, "labels": toks, **tex}, pc)[0]))
    assert abs(losses[0] - losses[1]) > 1e-6


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,cache_dtype", CROSS_DTYPES)
def test_prefill_then_decode(arch, dtype, cache_dtype):
    """Prefill logits and every cache, then three decode steps.  The
    float32-compute run with a bf16 cache holds the two rounding points of
    the cross-attention cache: prefill attends over fresh K/V, decode over
    the rounded cache."""
    jc, pc, jparams, model = pair(arch, dtype, seed=2)
    S = 20
    toks = np.random.default_rng(11).integers(0, pc.vocab_size, (2, S)).astype(np.int32)
    jex, tex = extras(pc, 2, seed=3)
    jl, jcaches = jlm.prefill(jparams, jnp.asarray(toks), jc, max_len=S + 4,
                              extra=jex, cache_dtype=JDT[cache_dtype])
    with torch.no_grad():
        tl, tcaches = lm.prefill(model, torch.from_numpy(toks), pc,
                                 max_len=S + 4, extra=tex,
                                 cache_dtype=TDT[cache_dtype])
        assert rel_err(tl, jl) < REL[dtype]
        jlayers = [{k: np.asarray(v[r], np.float32) for k, v in blk.items()}
                   for r in range(jc.n_repeat) for blk in jcaches["blocks"]]
        # a bf16 cache: the two sides' float32 K/V may round to bf16 values
        # one ulp apart
        cache_rel = max(REL[dtype], REL[cache_dtype])
        for c_t, c_j in zip(tcaches["layers"], jlayers, strict=True):
            assert set(c_t) == set(c_j)
            for key in c_j:
                assert c_t[key].dtype == TDT[cache_dtype]
                assert rel_err(c_t[key], c_j[key]) < cache_rel, key
        for step in range(3):
            nxt = np.argmax(np.asarray(jl, np.float32).reshape(2, -1), -1)
            nxt = nxt[:, None].astype(np.int32)
            jl, jcaches = jlm.decode_step(jparams, jnp.asarray(nxt), jcaches, jc)
            tl, tcaches = lm.decode_step(model, torch.from_numpy(nxt), tcaches, pc)
            assert tl.shape == (2, pc.vocab_size)
            assert rel_err(tl, jl) < REL[dtype], step
        assert tcaches["pos"] == S + 3


def test_decode_reads_the_rounded_cross_cache():
    """float32 compute, bf16 cache: the first decode step's logits differ
    from those of a float32 cache, since decode reads the rounded K/V."""
    _, pc, _, model = pair("whisper-tiny", "float32", seed=5)
    toks = np.random.default_rng(12).integers(0, pc.vocab_size, (2, 10)).astype(np.int32)
    _, tex = extras(pc, 2, seed=4)
    nxt = torch.zeros((2, 1), dtype=torch.int64)
    out = {}
    with torch.no_grad():
        for name, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            _, caches = lm.prefill(model, torch.from_numpy(toks), pc,
                                   max_len=16, extra=tex, cache_dtype=cdt)
            out[name] = lm.decode_step(model, nxt, caches, pc)[0]
    # rel 1.6e-3 on this seed: ten times the float32 bar, which the
    # reference comparison in test_prefill_then_decode holds
    assert rel_err(out["bf16"], out["f32"]) > 10 * REL["float32"]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generate_with_extras(arch):
    """Greedy tokens of the port's engine equal the JAX engine's in
    float32, the extras handed to ``generate``."""
    jc, pc, jparams, model = pair(arch, "float32", seed=3)
    toks = np.random.default_rng(13).integers(0, pc.vocab_size, (3, 16)).astype(np.int32)
    jex, tex = extras(pc, 3, seed=5)
    jeng = JaxServeEngine(jc, jparams, max_len=32, cache_dtype=jnp.float32)
    want = np.asarray(jeng.generate(jnp.asarray(toks), 6, extra=jex))
    eng = ServeEngine(pc, model, max_len=32, cache_dtype=torch.float32)
    got = eng.generate(torch.from_numpy(toks), 6, extra=tex)
    np.testing.assert_array_equal(got.numpy(), want)
    assert eng.stats["prefill_tokens"] == 3 * 16
    assert eng.stats["decode_tokens"] == 3 * 5


@pytest.mark.parametrize("arch", ARCHS)
def test_llm_serve_main_on_cpu(capsys, arch):
    assert llm_serve_main(["--arch", arch, "--device", "cpu",
                           "--prompt-len", "8", "--new-tokens", "3"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == arch
    assert out["generated_shape"] == [4, 3]
    assert out["device"] == "cpu"
    assert out["flash_launches"] == out["wkv6_launches"] == out["ssd_launches"] == 0


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_train_launcher_resumes_encoder_archs(tmp_path, arch):
    """Re-running the launcher with the same workdir resumes an encoder
    arch from its checkpoint: a run to step 3 after one to step 2 takes
    one step, its batch carrying enc_embed / img_embed like the rest."""
    args = ["--arch", arch, "--device", "cpu", "--reduced", "--batch", "2",
            "--seq", "16", "--ckpt-every", "1", "--workdir", str(tmp_path)]
    summary, _ = launch_train.main(args + ["--steps", "2"])
    assert summary["steps"] == 2 and summary["ran_steps"] == 2
    summary, tr = launch_train.main(args + ["--steps", "3"])
    assert summary["steps"] == 3 and summary["ran_steps"] == 1
    assert [h["step"] for h in tr.history] == [3]
    assert np.isfinite(tr.history[0]["loss"])


def test_train_launcher_takes_starcoder2(tmp_path):
    summary, _ = launch_train.main(
        ["--arch", "starcoder2-15b", "--device", "cpu", "--reduced",
         "--steps", "2", "--batch", "2", "--seq", "16", "--workdir",
         str(tmp_path)])
    assert summary["steps"] == 2 and summary["ran_steps"] == 2
    assert np.isfinite(summary["final_loss"])
