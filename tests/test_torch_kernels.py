"""Attention kernels of the PyTorch port against the JAX reference.

Inputs are made with numpy from a seed and handed to both frameworks.  The
JAX side runs the Pallas kernel in interpret mode (as tests/test_kernels.py
does) and its naive oracle; the port runs its plain versions, which are what
its wrapper computes for CPU tensors.  The CUDA kernel itself is checked on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import ops, ref

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, B, S, T, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), dtype=np.float32),
            rng.standard_normal((B, T, KV, D), dtype=np.float32),
            rng.standard_normal((B, T, KV, D), dtype=np.float32))


def _both(arrs, dtype):
    j = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    return j, t


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


SHAPES = [
    (1, 64, 64, 4, 4, 32),     # MHA square
    (2, 96, 96, 6, 2, 32),     # GQA, non-pow2 seq
    (1, 33, 70, 4, 1, 16),     # MQA, ragged cross shapes
    (2, 128, 128, 8, 4, 64),
]


@pytest.mark.parametrize("B,S,T,H,KV,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_vs_pallas_interpret(B, S, T, H, KV, D, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B * S + T, B, S, T, H, KV, D), dtype)
    want = jax_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                     interpret=True)
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, D)
    _close(got, want, ATOL[dtype], 1e-2)
    # the dispatcher on a CPU tensor is the plain version
    _close(ops.flash_attention(tq, tk, tv, causal=causal), want, ATOL[dtype], 1e-2)


@pytest.mark.parametrize("B,S,T,H,KV,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_naive_vs_jax_naive(B, S, T, H, KV, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(7 + S, B, S, T, H, KV, D), dtype)
    want = jref.naive_attention(jq, jk, jv, causal=True)
    _close(ref.naive_attention(tq, tk, tv, causal=True), want, ATOL[dtype], 1e-2)


@pytest.mark.parametrize("window,softcap,q_pos0", [
    (16, None, 0), (None, 30.0, 0), (24, 20.0, 0), (None, None, 16),
    (16, 30.0, 16),
])
def test_flash_window_softcap_qpos0(window, softcap, q_pos0):
    B, S, H, D = 2, 80, 4, 32
    T = S + q_pos0
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, B, S, T, H, 2, D), "float32")
    kw = dict(causal=True, window=window, softcap_val=softcap, q_pos0=q_pos0)
    want = jax_flash(jq, jk, jv, block_q=32, block_k=16, interpret=True, **kw)
    _close(ref.flash_attention_ref(tq, tk, tv, **kw), want, 2e-5, 1e-3)
    _close(ref.naive_attention(tq, tk, tv, **kw),
           jref.naive_attention(jq, jk, jv, **kw), 2e-5, 1e-3)
    # a small KV block exercises the online-softmax carry across blocks
    _close(ref.flash_attention_ref(tq, tk, tv, block_k=24, **kw), want, 2e-5, 1e-3)


@pytest.mark.parametrize("kv_len,window,softcap", [(40, None, None),
                                                   (64, 16, None),
                                                   (23, None, 20.0)])
def test_decode_attention_vs_jax(kv_len, window, softcap):
    B, T, H, KV, D = 2, 64, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(11, B, 1, T, H, KV, D), "float32")
    kw = dict(kv_len=kv_len, window=window, softcap_val=softcap)
    want = jref.decode_attention_ref(jq, jk, jv, **kw)
    _close(ops.decode_attention(tq, tk, tv, **kw), want, 2e-5, 1e-3)


def test_wrapper_checks_what_the_kernel_takes():
    q = torch.zeros(1, 8, 4, 64)
    kv = torch.zeros(1, 8, 2, 64)
    fak.check_args(q, kv, kv)  # accepted
    fak.check_args(q.bfloat16(), kv.bfloat16(), kv.bfloat16(), window=4, q_pos0=3)
    bad = [
        ((torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48),
          torch.zeros(1, 8, 2, 48)), {}, "head dim"),
        ((q.half(), kv.half(), kv.half()), {}, "dtypes"),
        ((q, kv.bfloat16(), kv), {}, "dtypes"),
        ((q, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64)), {}, "multiple"),
        ((q, kv, torch.zeros(1, 9, 2, 64)), {}, "shape mismatch"),
        ((q.transpose(1, 2), kv, kv), {}, "contiguous"),
        ((torch.zeros(1, 8, 4, 128)[..., :64], kv, kv), {}, "contiguous"),
        ((q, kv, kv), {"window": 0}, "window"),
        ((q, kv, kv), {"softcap_val": 0.0}, "softcap"),
        ((q, kv, kv), {"q_pos0": -1}, "q_pos0"),
    ]
    for args, kw, msg in bad:
        with pytest.raises(ValueError, match=msg):
            fak.check_args(*args, **kw)


def test_cpu_wrapper_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 16, 16, 2, 2, 16))
    before = fak.launches
    out = fak.flash_attention(q, k, v)
    assert fak.launches == before
    torch.testing.assert_close(out, ref.naive_attention(q, k, v), atol=2e-5,
                               rtol=1e-3)


def test_dispatcher_rejects_unknown_mode():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="use_pallas"):
        ops.flash_attention(q, q, q, use_pallas="interpret")
