"""The WKV6 and SSD scans of the PyTorch port against the JAX reference.

Inputs are made with numpy from a seed and handed to both frameworks.  The
JAX side runs its Pallas kernels in interpret mode (as tests/test_kernels.py
does) and its plain references; the port runs its plain versions, which are
what its wrappers compute for CPU tensors.  The bars are
tests/test_kernels.py's: max |got - want| / max |want| below 1e-4 in float32
and 4e-2 in bfloat16.  The CUDA kernels themselves are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd
from repro.kernels.wkv6_scan import wkv6_scan as jax_wkv6
from repro.models.rwkv import _wkv_final_state as jax_wkv_final_state
from repro.models.ssm import _final_state as jax_ssd_final_state
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssdk
from repro_torch.kernels import wkv6_scan as wkvk
from repro_torch.models.rwkv import _wkv_final_state
from repro_torch.models.ssm import _final_state as ssd_final_state

REL = {"float32": 1e-4, "bfloat16": 4e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def both(arrs, dtypes):
    """numpy arrays -> (jax arrays, torch tensors), each in its dtype."""
    j = [jnp.asarray(a).astype(jnp.dtype(d)) for a, d in zip(arrs, dtypes)]
    t = [torch.from_numpy(a).to(TDT[d]) for a, d in zip(arrs, dtypes)]
    return j, t


def ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=np.float32))) * 0.5
    A = -np.exp(rng.standard_normal(H, dtype=np.float32))
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    return x, dt, A, Bm, Cm


def wkv_inputs(seed, B, S, H, D):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D), dtype=np.float32)
               for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-(rng.standard_normal((B, S, H, D),
                                                  dtype=np.float32) + 2.0)))
    u = rng.standard_normal((H, D), dtype=np.float32) * 0.1
    return r, k, v, w.astype(np.float32), u


# ---------------------------------------------------------------------------
# SSD (Mamba2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 3, 8, 16, 16), (1, 128, 2, 16, 32, 32), (2, 96, 4, 8, 8, 48),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_vs_pallas_interpret(B, S, H, P, N, chunk, dtype):
    dts = [dtype, "float32", "float32", dtype, dtype]
    j, t = both(ssd_inputs(B * S + N, B, S, H, P, N), dts)
    want_seq = jref.ssd_scan_ref(*j)
    want_kernel = jax_ssd(*j, chunk=chunk, interpret=True)
    got = ref.ssd_chunked_ref(*t, chunk=chunk)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, P)
    assert rel(got, want_kernel) < REL[dtype]
    assert rel(got, want_seq) < REL[dtype]
    assert rel(ref.ssd_scan_ref(*t), want_seq) < REL[dtype]
    # the dispatcher and the wrapper on CPU tensors are the plain version
    assert rel(ops.ssd_scan(*t, chunk=chunk), want_kernel) < REL[dtype]
    assert rel(ssdk.ssd_scan(*t, chunk=chunk), want_kernel) < REL[dtype]


def test_ssd_decode_matches_scan_tail():
    B, S, H, P, N = 2, 32, 3, 8, 16
    j, t = both(ssd_inputs(9, B, S, H, P, N), ["float32"] * 5)
    full = jref.ssd_scan_ref(*j)
    x, dt, A, Bm, Cm = t
    h = ssd_final_state(x[:, :S - 1], dt[:, :S - 1], A, Bm[:, :S - 1], Cm[:, :S - 1])
    jh = jax_ssd_final_state(*(a[:, :S - 1] if a.ndim > 1 else a for a in j))
    assert rel(h, jh) < 1e-5
    h2, y = ref.ssd_decode_ref(h, x[:, -1], dt[:, -1], A, Bm[:, -1], Cm[:, -1])
    jh2, jy = jref.ssd_decode_ref(jh, j[0][:, -1], j[1][:, -1], j[2],
                                  j[3][:, -1], j[4][:, -1])
    np.testing.assert_allclose(y.numpy(), np.asarray(full[:, -1]),
                               atol=1e-4, rtol=1e-3)
    assert rel(y, jy) < 1e-5 and rel(h2, jh2) < 1e-5
    assert ops.ssd_decode(h, x[:, -1], dt[:, -1], A, Bm[:, -1], Cm[:, -1])[1] \
        .equal(y)


# ---------------------------------------------------------------------------
# WKV6 (RWKV)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,D,chunk", [
    (2, 64, 3, 16, 16), (1, 128, 2, 32, 32), (2, 96, 4, 16, 48),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_plain_vs_pallas_interpret(B, S, H, D, chunk, dtype):
    j, t = both(wkv_inputs(B * S + D, B, S, H, D), [dtype] * 4 + ["float32"])
    want_seq = jref.wkv6_scan_ref(*j)
    want_kernel = jax_wkv6(*j, chunk=chunk, interpret=True)
    got = ref.wkv6_chunked_ref(*t, chunk=chunk)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, D)
    assert rel(got, want_kernel) < REL[dtype]
    assert rel(got, want_seq) < REL[dtype]
    assert rel(ref.wkv6_scan_ref(*t), want_seq) < REL[dtype]
    sub = 16 if chunk % 16 == 0 else 8
    blocked = ref.wkv6_blocked_ref(*t, chunk=chunk, subchunk=sub)
    assert rel(blocked, jref.wkv6_blocked_ref(*j, chunk=chunk, subchunk=sub)) \
        < REL[dtype]
    assert rel(blocked, want_seq) < REL[dtype]
    assert rel(wkvk.wkv6_scan(*t, chunk=chunk), want_kernel) < REL[dtype]


def test_wkv6_decode_matches_scan_tail():
    B, S, H, D = 2, 24, 2, 16
    j, t = both(wkv_inputs(20, B, S, H, D), ["float32"] * 5)
    full = jref.wkv6_scan_ref(*j)
    r, k, v, w, u = t
    st = _wkv_final_state(k[:, :S - 1], v[:, :S - 1], w[:, :S - 1])
    jst = jax_wkv_final_state(j[1][:, :S - 1], j[2][:, :S - 1], j[3][:, :S - 1])
    assert rel(st, jst) < 1e-5
    st2, y = ref.wkv6_decode_ref(st, r[:, -1], k[:, -1], v[:, -1], w[:, -1], u)
    jst2, jy = jref.wkv6_decode_ref(jst, *(a[:, -1] for a in j[:4]), j[4])
    np.testing.assert_allclose(y.numpy(), np.asarray(full[:, -1]),
                               atol=1e-4, rtol=1e-3)
    assert rel(y, jy) < 1e-5 and rel(st2, jst2) < 1e-5
    assert ops.wkv6_decode(st, r[:, -1], k[:, -1], v[:, -1], w[:, -1], u)[1] \
        .equal(y)


# ---------------------------------------------------------------------------
# the dispatcher's padding of ragged sequences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,S,chunk", [("chunked", 37, 16),
                                          ("blocked", 37, 16),
                                          ("blocked", 50, 24),
                                          ("chunked", 5, 64)])
def test_wkv6_ops_pads_ragged_sequences(impl, S, chunk):
    j, t = both(wkv_inputs(30 + S, 2, S, 3, 16), ["float32"] * 5)
    want = jops.wkv6_scan(*j, chunk=chunk, use_pallas="never", impl=impl,
                          subchunk=16)
    got = ops.wkv6_scan(*t, chunk=chunk, impl=impl, subchunk=16)
    assert got.shape == (2, S, 3, 16)
    assert rel(got, want) < 1e-4
    assert rel(got, jref.wkv6_scan_ref(*j)) < 1e-4
    # w is padded with 1.0 (log-decay 0): the padding is inert
    Sp = -(-S // min(chunk, S)) * min(chunk, S)
    (wp,) = ops._pad_seq((t[3],), min(chunk, S), value=1.0)
    assert wp.shape[1] == Sp and bool((wp[:, S:] == 1.0).all())


@pytest.mark.parametrize("S,chunk", [(37, 16), (50, 256), (64, 32)])
def test_ssd_ops_pads_ragged_sequences(S, chunk):
    j, t = both(ssd_inputs(40 + S, 2, S, 3, 8, 16), ["float32"] * 5)
    want = jops.ssd_scan(*j, chunk=chunk, use_pallas="never")
    got = ops.ssd_scan(*t, chunk=chunk)
    assert got.shape == (2, S, 3, 8)
    assert rel(got, want) < 1e-4
    assert rel(got, jref.ssd_scan_ref(*j)) < 1e-4


# ---------------------------------------------------------------------------
# the wrappers: argument checks and the CPU path
# ---------------------------------------------------------------------------

def test_wkv6_wrapper_checks_what_the_kernel_takes():
    x = torch.zeros(1, 8, 2, 64)
    u = torch.zeros(2, 64)
    wkvk.check_args(x, x, x, x, u)  # accepted
    xb = x.bfloat16()
    wkvk.check_args(xb, xb, xb, x, u)
    bad = [
        ((torch.zeros(1, 8, 2, 48),) * 4 + (torch.zeros(2, 48),), "head dim"),
        ((x.half(), x.half(), x.half(), x, u), "dtypes"),
        ((x, xb, x, x, u), "dtypes"),
        ((x, x, x, xb, u), "dtypes"),
        ((x, x, x, x, u.bfloat16()), "dtypes"),
        ((x, x, torch.zeros(1, 9, 2, 64), x, u), "shape mismatch"),
        ((x, x, x, x, torch.zeros(3, 64)), "shape mismatch"),
        ((x.transpose(1, 2).contiguous().transpose(1, 2), x, x, x, u),
         "contiguous"),
        ((torch.zeros(1, 8, 2, 128)[..., :64], x, x, x, u), "contiguous"),
        ((x[0], x, x, x, u), "4-d"),
    ]
    for args, msg in bad:
        with pytest.raises(ValueError, match=msg):
            wkvk.check_args(*args)


def test_ssd_wrapper_checks_what_the_kernel_takes():
    x = torch.zeros(1, 8, 2, 64)
    dt = torch.zeros(1, 8, 2)
    A = torch.zeros(2)
    bc = torch.zeros(1, 8, 64)
    ssdk.check_args(x, dt, A, bc, bc)  # accepted
    ssdk.check_args(x.bfloat16(), dt, A, bc.bfloat16(), bc.bfloat16())
    bad = [
        ((torch.zeros(1, 8, 2, 48), dt, A, bc, bc), "head dim"),
        ((x, dt, A, torch.zeros(1, 8, 24), torch.zeros(1, 8, 24)), "state dim"),
        ((x.half(), dt, A, bc.half(), bc.half()), "dtypes"),
        ((x, dt, A, bc.bfloat16(), bc), "dtypes"),
        ((x, dt.bfloat16(), A, bc, bc), "dtypes"),
        ((x, torch.zeros(1, 8, 3), A, bc, bc), "shape mismatch"),
        ((x, dt, A, bc, torch.zeros(1, 8, 32)), "shape mismatch"),
        ((x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, bc, bc),
         "contiguous"),
        ((x, dt, A, torch.zeros(1, 8, 128)[..., :64], bc), "contiguous"),
        ((x, dt[0], A, bc, bc), "must be"),
    ]
    for args, msg in bad:
        with pytest.raises(ValueError, match=msg):
            ssdk.check_args(*args)


def test_cpu_wrappers_count_no_launch():
    _, t = both(wkv_inputs(5, 1, 16, 2, 16), ["float32"] * 5)
    before = wkvk.launches
    torch.testing.assert_close(wkvk.wkv6_scan(*t, chunk=8),
                               ref.wkv6_chunked_ref(*t, chunk=8))
    assert wkvk.launches == before
    _, t = both(ssd_inputs(6, 1, 16, 2, 8, 16), ["float32"] * 5)
    before = ssdk.launches
    torch.testing.assert_close(ssdk.ssd_scan(*t, chunk=8),
                               ref.ssd_chunked_ref(*t, chunk=8))
    assert ssdk.launches == before


def test_scan_dispatchers_reject_unknown_mode():
    _, t = both(wkv_inputs(7, 1, 8, 2, 16), ["float32"] * 5)
    with pytest.raises(ValueError, match="use_pallas"):
        ops.wkv6_scan(*t, use_pallas="interpret")
    _, t = both(ssd_inputs(8, 1, 8, 2, 8, 16), ["float32"] * 5)
    with pytest.raises(ValueError, match="use_pallas"):
        ops.ssd_scan(*t, use_pallas="interpret")
