"""Attention variants and MoE of the PyTorch port against the JAX reference,
on the CPU at reduced sizes: the int8 cache helpers, the MLA layer (prefill;
decode absorbed and not; bf16 and int8 caches), the MoE layer (``gshard``
and ``sort``, with and without drops, grouping, aux losses, the queue
positions and the capacity), gemma2's sliding window at the stack level,
qk-norm at the stack level, and what the flash wrapper takes at D = 192.

Inputs and weights are made with numpy or on the JAX side and handed over
as numpy arrays.  float32 compute agrees to rel 1e-4; bf16 compute to rel
5e-2, since bf16 rounds at different places in the two frameworks.  The
reference's flash attention runs on its plain path, as its own CPU tests
run it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import LayerSpec as JLayerSpec
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import moe as jM
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.configs.base import LayerSpec
from repro_torch.kernels import flash_attention as fak
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import moe as M
from repro_torch.serve.engine import ServeEngine

REL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int8": torch.int8}


def rel_err(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def to_numpy(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def load(module, np_dict):
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in flat(np_dict).items()})
    return module


def configs(arch, **over):
    return (jreg.reduced_config(arch).replace(**over),
            preg.reduced_config(arch).replace(**over))


# ---------------------------------------------------------------------------
# int8 cache helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_cache_store_and_load(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32) * 2.0
    # exact half steps (round half to even) and values past the clip
    x[0, 0, :6] = np.array([0.5, 1.5, 2.5, -0.5, 4.0, -5.0]) / L.CACHE_QSCALE
    want = jL.cache_store(jnp.asarray(x), JDT[dtype])
    got = L.cache_store(torch.from_numpy(x), TDT[dtype])
    assert got.dtype == TDT[dtype]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    for cdt in ("float32", "bfloat16"):
        back = L.cache_load(got, TDT[cdt])
        assert back.dtype == TDT[cdt]
        np.testing.assert_array_equal(
            back.float().numpy(),
            np.asarray(jL.cache_load(want, JDT[cdt]), np.float32))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_pair(dtype, **over):
    jc, pc = configs("deepseek-v2-lite-16b", compute_dtype=dtype, **over)
    jp = to_numpy(jL.init_mla(jax.random.PRNGKey(1), jc))
    jp["kv_norm"]["scale"] += 0.2  # the (1 + scale) form
    mod = load(L.init_mla(torch.Generator().manual_seed(0), pc, "cpu"), jp)
    return jc, pc, jax.tree.map(jnp.asarray, jp), mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill(dtype):
    jc, pc, jp, mod = _mla_pair(dtype)
    x = np.random.default_rng(3).standard_normal((2, 21, pc.d_model),
                                                 dtype=np.float32)
    want, jnc = jL.mla_attention(jp, jnp.asarray(x).astype(JDT[dtype]), jc,
                                 jc.superblock[0], positions=jnp.arange(21))
    with torch.no_grad():
        got, tnc = L.mla_attention(mod, torch.from_numpy(x).to(TDT[dtype]),
                                   pc, pc.superblock[0],
                                   positions=torch.arange(21))
    assert jnc is None and tnc is None
    assert rel_err(got, want) < REL[dtype]


@pytest.mark.parametrize("dtype,cache_dtype", [
    ("float32", "float32"), ("float32", "int8"),
    ("bfloat16", "bfloat16"), ("bfloat16", "int8")])
@pytest.mark.parametrize("absorb", [True, False])
def test_mla_prefill_then_decode_with_cache(dtype, cache_dtype, absorb):
    """A prefill writes the latent and rope-key caches and attends within
    its chunk; two decode steps read the caches (absorbed into the latent
    space or not)."""
    jc, pc, jp, mod = _mla_pair(dtype, mla_absorb=absorb)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 19, pc.d_model), dtype=np.float32)
    S, T = 17, 24
    jcache = jL.init_mla_cache(jc, 2, T, JDT[cache_dtype])
    tcache = L.init_mla_cache(pc, 2, T, TDT[cache_dtype], "cpu")
    steps = [(0, x[:, :S])] + [(S + i, x[:, S + i:S + i + 1]) for i in range(2)]
    for pos, xs in steps:
        n = xs.shape[1]
        want, jcache = jL.mla_attention(
            jp, jnp.asarray(xs).astype(JDT[dtype]), jc, jc.superblock[0],
            positions=pos + jnp.arange(n), cache=jcache, cache_pos=pos)
        with torch.no_grad():
            got, tcache = L.mla_attention(
                mod, torch.from_numpy(xs).to(TDT[dtype]), pc,
                pc.superblock[0], positions=pos + torch.arange(n),
                cache=tcache, cache_pos=pos)
        assert rel_err(got, want) < REL[dtype], pos
        for key in ("latent", "k_rope"):
            assert tcache[key].dtype == TDT[cache_dtype]
            g = tcache[key].float().numpy()
            w = np.asarray(jcache[key], np.float32)
            if cache_dtype == "int8":  # equal up to a rounding at a half step
                assert np.abs(g - w).max() <= (1 if dtype == "float32" else 2)
                assert (g != w).mean() < (1e-3 if dtype == "float32" else 5e-2)
            else:
                assert rel_err(g, w) < REL[dtype], (pos, key)


def test_mla_decode_forms_agree():
    """The absorbed and the plain decode compute the same attention."""
    outs = []
    for absorb in (True, False):
        _, pc, _, mod = _mla_pair("float32", mla_absorb=absorb)
        cache = L.init_mla_cache(pc, 2, 16, torch.float32, "cpu")
        x = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (2, 10, pc.d_model), dtype=np.float32))
        with torch.no_grad():
            L.mla_attention(mod, x[:, :9], pc, pc.superblock[0],
                            positions=torch.arange(9), cache=cache,
                            cache_pos=0)
            out, _ = L.mla_attention(mod, x[:, 9:], pc, pc.superblock[0],
                                     positions=torch.tensor([9]), cache=cache,
                                     cache_pos=9)
        outs.append(out)
    assert rel_err(outs[0], outs[1].numpy()) < 1e-5


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_pair(arch, dtype, **over):
    jc, pc = configs(arch, compute_dtype=dtype, **over)
    jp = to_numpy(jM.init_moe(jax.random.PRNGKey(2), jc))
    mod = load(M.init_moe(torch.Generator().manual_seed(0), pc, "cpu"), jp)
    return jc, pc, jax.tree.map(jnp.asarray, jp), mod


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
@pytest.mark.parametrize("impl", ["gshard", "sort"])
@pytest.mark.parametrize("capacity_factor,drops", [(100.0, False), (0.5, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer(arch, impl, capacity_factor, drops, dtype):
    jc, pc, jp, mod = _moe_pair(arch, dtype, moe_impl=impl,
                                capacity_factor=capacity_factor)
    x = np.random.default_rng(6).standard_normal((2, 20, pc.d_model),
                                                 dtype=np.float32)
    jx = jnp.asarray(x).astype(JDT[dtype])
    want, jaux = jM.moe_layer(jp, jx, jc)
    with torch.no_grad():
        got, taux = M.moe_layer(mod, torch.from_numpy(x).to(TDT[dtype]), pc)
    assert got.dtype == TDT[dtype]
    assert rel_err(got, want) < REL[dtype]
    for key in ("moe_lb_loss", "moe_z_loss"):
        assert rel_err(taux[key], jaux[key]) < REL[dtype], key
    # the drops happen (or not) on both sides alike
    ids, _, _ = jM._route(jp, jx.reshape(1, 40, -1), jc)
    pos = np.asarray(jM._positions_in_expert(ids, jc.n_experts))
    assert bool((pos >= jM._capacity(jc, 40)).any()) == drops


@pytest.mark.parametrize("impl", ["gshard", "sort"])
def test_moe_groups(impl):
    """B*S a multiple of moe_group: several dispatch groups, each with its
    own capacity and drops."""
    jc, pc, jp, mod = _moe_pair("deepseek-v2-lite-16b", "float32",
                                moe_impl=impl, moe_group=8,
                                capacity_factor=0.5)
    x = np.random.default_rng(7).standard_normal((2, 20, pc.d_model),
                                                 dtype=np.float32)
    want, _ = jM.moe_layer(jp, jnp.asarray(x), jc)
    with torch.no_grad():
        got, _ = M.moe_layer(mod, torch.from_numpy(x), pc)
    assert rel_err(got, want) < REL["float32"]


def test_moe_sort_equals_gshard_with_drops():
    outs = {}
    for impl in ("gshard", "sort"):
        _, pc, _, mod = _moe_pair("arctic-480b", "float32", moe_impl=impl,
                                  capacity_factor=0.5)
        x = torch.from_numpy(np.random.default_rng(8).standard_normal(
            (2, 16, pc.d_model), dtype=np.float32))
        with torch.no_grad():
            outs[impl], _ = M.moe_layer(mod, x, pc)
    torch.testing.assert_close(outs["sort"], outs["gshard"], atol=1e-5,
                               rtol=1e-5)


def test_positions_in_expert_and_capacity():
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 8, (3, 50, 2)).astype(np.int32)
    want = jM._positions_in_expert(jnp.asarray(ids), 8)
    got = M._positions_in_expert(torch.from_numpy(ids).long(), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jc, pc = configs("deepseek-v2-lite-16b")
    for cf in (1e-9, 0.5, 1.0, 1.25, 2.0):
        for T in (1, 4, 7, 40, 1024, 2048):
            assert M._capacity(pc.replace(capacity_factor=cf), T) == \
                jM._capacity(jc.replace(capacity_factor=cf), T), (cf, T)


def test_top_k_breaks_ties_by_lower_index():
    """bf16 router logits tie often; lax.top_k takes the lower index."""
    rng = np.random.default_rng(10)
    x = rng.integers(0, 4, (5, 30, 16)).astype(np.float32) / 4.0  # many ties
    for k in (1, 2, 6):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = M._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_one_hot_gives_zero_rows_out_of_range():
    idx = torch.tensor([[0, 3, 4, 7]])
    got = M._one_hot(idx, 4, torch.float32)
    want = jax.nn.one_hot(jnp.asarray([[0, 3, 4, 7]]), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the stack: gemma2's window, qk-norm
# ---------------------------------------------------------------------------

def _stack_pair(jc, pc, seed, perturb=None):
    jparams = jlm.init_params(jax.random.PRNGKey(seed), jc)
    tree = to_numpy(jparams)
    if perturb is not None:
        perturb(tree)
        jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, convert.params_from_jax(tree, pc, "cpu")


def _windowed_gemma2(dtype, window=8):
    jc, pc = configs("gemma2-27b", compute_dtype=dtype)
    jc = jc.replace(superblock=(JLayerSpec(kind="attn", mlp="glu",
                                           sliding_window=window),
                                JLayerSpec(kind="attn", mlp="glu")))
    pc = pc.replace(superblock=(LayerSpec(kind="attn", mlp="glu",
                                          sliding_window=window),
                                LayerSpec(kind="attn", mlp="glu")))
    return jc, pc


def _sandwich(tree):
    """Nonzero post-norm scales, so sandwich norms are not the identity
    form (1 + 0)."""
    rng = np.random.default_rng(11)
    for block in tree["blocks"]:
        for name in ("norm1_post", "norm2_post"):
            s = block[name]["scale"]
            block[name]["scale"] = (s + rng.standard_normal(s.shape) * 0.3
                                    ).astype(np.float32)


def _prefill_decode(jc, pc, jparams, model, toks, max_len, dtype, steps=3):
    B = toks.shape[0]
    jl, jcaches = jlm.prefill(jparams, jnp.asarray(toks), jc, max_len=max_len,
                              cache_dtype=JDT[dtype])
    with torch.no_grad():
        tl, tcaches = lm.prefill(model, torch.from_numpy(toks), pc,
                                 max_len=max_len, cache_dtype=TDT[dtype])
        assert rel_err(tl, jl) < REL[dtype]
        for step in range(steps):
            nxt = np.argmax(np.asarray(jl, np.float32).reshape(B, -1), -1)
            nxt = nxt[:, None].astype(np.int32)
            jl, jcaches = jlm.decode_step(jparams, jnp.asarray(nxt), jcaches, jc)
            tl, tcaches = lm.decode_step(model, torch.from_numpy(nxt), tcaches,
                                         pc)
            assert rel_err(tl, jl) < REL[dtype], step
    return tcaches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma2_window_shorter_than_the_prompt(dtype):
    """Local layers with a window of 8 on both sides and a 20-token prompt:
    the window mask, the local caches' roll at prefill (S > Lbuf), decode
    past the window, softcaps, sandwich norms and embed_scale."""
    jc, pc = _windowed_gemma2(dtype)
    jparams, model = _stack_pair(jc, pc, 12, _sandwich)
    toks = np.random.default_rng(12).integers(0, pc.vocab_size, (2, 20)
                                              ).astype(np.int32)
    want, _ = jlm.forward_train(jparams, jnp.asarray(toks), jc)
    with torch.no_grad():
        got, _ = lm.forward_train(model, torch.from_numpy(toks), pc)
    assert rel_err(got, want) < REL[dtype]
    caches = _prefill_decode(jc, pc, jparams, model, toks, 26, dtype)
    lens = [c["k"].shape[1] for c in caches["layers"]]
    assert lens == [8, 26] * pc.n_repeat


def test_gemma2_engine_greedy_tokens_with_window():
    jc, pc = _windowed_gemma2("float32")
    jparams, model = _stack_pair(jc, pc, 13, _sandwich)
    toks = np.random.default_rng(13).integers(0, pc.vocab_size, (3, 16)
                                              ).astype(np.int32)
    jeng = JaxServeEngine(jc, jparams, max_len=32, cache_dtype=jnp.float32)
    want = np.asarray(jeng.generate(jnp.asarray(toks), 6))
    eng = ServeEngine(pc, model, max_len=32, cache_dtype=torch.float32)
    np.testing.assert_array_equal(eng.generate(torch.from_numpy(toks), 6)
                                  .numpy(), want)


def _qk_scales(tree):
    rng = np.random.default_rng(14)
    for block in tree["blocks"]:
        for name in ("qnorm", "knorm"):
            s = block["attn"][name]["scale"]
            block["attn"][name]["scale"] = (
                s + rng.standard_normal(s.shape) * 0.3).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("extra", [4, -5])  # cache longer / rolled
def test_qk_norm_stack(dtype, extra):
    """No reference config sets qk_norm: the flag on phi4's reduced stack,
    prefill then decode against the reference (the rolled cache included)."""
    jc, pc = configs("phi4-mini-3.8b", compute_dtype=dtype, qk_norm=True)
    jparams, model = _stack_pair(jc, pc, 15, _qk_scales)
    toks = np.random.default_rng(15).integers(0, pc.vocab_size, (2, 20)
                                              ).astype(np.int32)
    _prefill_decode(jc, pc, jparams, model, toks, 20 + extra, dtype)


# ---------------------------------------------------------------------------
# the flash wrapper at D = 192
# ---------------------------------------------------------------------------

def test_flash_wrapper_takes_d192_forward_only():
    """D 192 (MLA) was the forward's alone until the backward kernel took
    it too: the backward's check takes every head dim the forward takes,
    and a head dim outside HEAD_DIMS (256) is refused by both."""
    q = torch.zeros(1, 8, 4, 192)
    kv = torch.zeros(1, 8, 2, 192)
    fak.check_args(q, kv, kv)  # the forward takes it
    fak.check_args(q.bfloat16(), kv.bfloat16(), kv.bfloat16(), window=4)
    for d in (16, 32, 64, 128, 192):
        fak.check_backward_args(torch.zeros(1, 8, 4, d), torch.zeros(1, 8, 2, d))
    with pytest.raises(ValueError, match="head dim"):
        fak.check_args(torch.zeros(1, 8, 4, 256), torch.zeros(1, 8, 2, 256),
                       torch.zeros(1, 8, 2, 256))


@pytest.mark.parametrize("arch,leaf", [
    ("deepseek-v2-lite-16b", ("blocks", 0, "mlp", "w_router")),
    ("deepseek-v2-lite-16b", ("blocks", 0, "attn", "kv_norm")),
    ("arctic-480b", ("blocks", 0, "res_mlp", "wg")),
    ("gemma2-27b", ("blocks", 1, "norm2_post")),
])
def test_convert_loads_the_new_leaves_strictly(arch, leaf):
    """Every MLA, MoE, dense-residual and sandwich-norm leaf must be in the
    reference's tree: one missing raises instead of keeping a random init."""
    jc, pc = configs(arch)
    tree = to_numpy(jlm.init_params(jax.random.PRNGKey(0), jc))
    convert.params_from_jax(tree, pc, "cpu")  # complete: loads
    node = tree
    for key in leaf[:-1]:
        node = node[key]
    del node[leaf[-1]]
    with pytest.raises(RuntimeError, match="Missing key"):
        convert.params_from_jax(tree, pc, "cpu")
