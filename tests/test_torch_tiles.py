"""The rounding points of the port's tensor-core kernel designs, on the CPU.

``ref.flash_attention_tc_ref``, ``ref.wkv6_subtile_ref`` and
``ref.ssd_subtile_ref`` mirror where the bf16 CUDA kernels round (logits
scaled after the product and P in bf16 for flash attention; 16-row chunks
for WKV6 and 64-row tiles for the SSD scan, with split bf16 operands and a
float32 state).  Here they are held against the JAX Pallas kernels in
interpret mode (as tests/test_torch_kernels.py and tests/test_torch_scans.py
run them) at rel 1e-2 in bf16, and, where nothing is rounded (float32
inputs), against the port's existing plain versions to float32 rounding, or
under strong decays the sequential oracles.  The kernels
themselves are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ssd_scan import ssd_scan as jax_ssd
from repro.kernels.wkv6_scan import wkv6_scan as jax_wkv6
from repro_torch.kernels import ref

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_REL = 1e-2   # the bar the card holds the bf16 kernels to
F32_REL = 1e-5    # float32: the same algorithm summed in another order


def rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def both(arrs, dtypes):
    j = [jnp.asarray(a).astype(jnp.dtype(d)) for a, d in zip(arrs, dtypes)]
    t = [torch.from_numpy(a).to(TDT[d]) for a, d in zip(arrs, dtypes)]
    return j, t


def qkv(seed, B, S, T, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), dtype=np.float32),
            rng.standard_normal((B, T, KV, D), dtype=np.float32),
            rng.standard_normal((B, T, KV, D), dtype=np.float32))


def wkv_inputs(seed, B, S, H, D, strong=False):
    """``strong``: w = exp(-exp(N(1, 2))), which reaches the clip at 1e-12."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D), dtype=np.float32)
               for _ in range(3))
    n = rng.standard_normal((B, S, H, D), dtype=np.float32)
    w = np.exp(-np.exp(1.0 + 2.0 * n)) if strong else 1.0 / (1.0 + np.exp(-(n + 2.0)))
    u = rng.standard_normal((H, D), dtype=np.float32) * 0.1
    return r, k, v, w.astype(np.float32), u


# (B, S, T, H, KV, D, causal, window, softcap, q_pos0)
FLASH_CASES = [
    (2, 96, 96, 4, 2, 32, True, None, None, 0),
    (1, 33, 70, 4, 1, 16, False, None, None, 0),
    (2, 80, 80, 4, 2, 32, True, 24, 20.0, 0),
    (1, 48, 64, 4, 4, 64, True, None, None, 16),
    (1, 45, 83, 4, 2, 64, False, None, None, 0),
]


@pytest.mark.parametrize("B,S,T,H,KV,D,causal,window,softcap,q_pos0",
                         FLASH_CASES)
def test_flash_tc_mirror_vs_pallas_interpret_bf16(B, S, T, H, KV, D, causal,
                                                  window, softcap, q_pos0):
    (jq, jk, jv), (tq, tk, tv) = both(qkv(S + T, B, S, T, H, KV, D),
                                      ["bfloat16"] * 3)
    kw = dict(causal=causal, window=window, softcap_val=softcap, q_pos0=q_pos0)
    want = jax_flash(jq, jk, jv, block_q=32, block_k=32, interpret=True, **kw)
    got = ref.flash_attention_tc_ref(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, D)
    assert rel(got, want) < BF16_REL


@pytest.mark.parametrize("B,S,T,H,KV,D,causal,window,softcap,q_pos0",
                         FLASH_CASES)
def test_flash_tc_mirror_equals_plain_in_float32(B, S, T, H, KV, D, causal,
                                                 window, softcap, q_pos0):
    _, (tq, tk, tv) = both(qkv(S * T, B, S, T, H, KV, D), ["float32"] * 3)
    kw = dict(causal=causal, window=window, softcap_val=softcap, q_pos0=q_pos0)
    assert rel(ref.flash_attention_tc_ref(tq, tk, tv, **kw),
               ref.flash_attention_ref(tq, tk, tv, **kw)) < F32_REL


def test_flash_tc_mirror_rounds_p_in_bf16():
    """The mirror is not the fp32-P plain version: rounding P moves the
    result by more than float32 rounding and less than the bf16 bar."""
    _, (tq, tk, tv) = both(qkv(5, 1, 64, 64, 2, 2, 32), ["bfloat16"] * 3)
    a = ref.flash_attention_tc_ref(tq, tk, tv).float()
    b = ref.flash_attention_ref(tq, tk, tv).float()
    assert 0 < float((a - b).abs().max()) and rel(a, b) < BF16_REL


# (B, S, H, D, chunk): chunk is the Pallas kernel's; the mirror takes any S
WKV_CASES = [(2, 64, 3, 16, 16), (1, 128, 2, 32, 32), (2, 96, 4, 16, 48),
             (1, 48, 2, 64, 48)]


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("B,S,H,D,chunk", WKV_CASES)
def test_wkv_subtile_mirror_vs_pallas_interpret_bf16(B, S, H, D, chunk, strong):
    j, t = both(wkv_inputs(B * S + D, B, S, H, D, strong),
                ["bfloat16"] * 3 + ["float32"] * 2)
    want = jax_wkv6(*j, chunk=chunk, interpret=True)
    got = ref.wkv6_subtile_ref(*t)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, D)
    assert rel(got, want) < BF16_REL


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("B,S,H,D,chunk", WKV_CASES)
def test_wkv_subtile_mirror_equals_plain_in_float32(B, S, H, D, chunk,
                                                    strong):
    """Against the chunked plain version or, under strong decays, the
    sequential oracle: there the chunked form's cumsums reach -27.6 * chunk
    and their difference loses ~1e-4 to cancellation, which 16-row chunks
    avoid."""
    _, t = both(wkv_inputs(7 + S, B, S, H, D, strong), ["float32"] * 5)
    want = (ref.wkv6_scan_ref(*t) if strong
            else ref.wkv6_chunked_ref(*t, chunk=chunk))
    assert rel(ref.wkv6_subtile_ref(*t), want) < F32_REL


@pytest.mark.parametrize("S", [1, 15, 17, 50])
def test_wkv_subtile_mirror_takes_ragged_sequences(S):
    """A ragged last sub-tile is cut to the rows that exist: the result
    equals the sequential oracle on the same rows."""
    _, t = both(wkv_inputs(S, 2, S, 3, 16, strong=True), ["float32"] * 5)
    assert rel(ref.wkv6_subtile_ref(*t), ref.wkv6_scan_ref(*t)) < F32_REL


def test_wkv_subtile_mirror_bf16_state_at_rwkv6_3b_prefill():
    """rwkv6-3b's 512 prefill (B=4, H=40, D=64) with both kinds of decay:
    the bf16 operands and the bf16 copy of the state stay inside the card's
    bar against the float32 sequential oracle on the same inputs.  A CPU
    check of the design (``-s`` prints the errors), not a card number."""
    for strong in (False, True):
        _, t = both(wkv_inputs(13, 4, 512, 40, 64, strong),
                    ["bfloat16"] * 3 + ["float32"] * 2)
        got = ref.wkv6_subtile_ref(*t)
        r, k, v, w, u = t
        want = ref.wkv6_scan_ref(r.float(), k.float(), v.float(), w, u)
        err = rel(got, want)
        print(f"wkv6_subtile_ref bf16 vs float32 oracle, 4x512x40x64, "
              f"strong={strong}: rel {err:.3e}")
        assert err < BF16_REL


def ssd_inputs(seed, B, S, H, P, N, strong=False):
    """``strong``: A = -exp(N(1.5, 1)) and dt = softplus(N(0, 1)), a decay
    of about e^-3 a step, so acs reaches -100s within a tile and its
    differences cancel."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=np.float32)))
    A = -np.exp(rng.standard_normal(H, dtype=np.float32)
                + (1.5 if strong else 0.0))
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    return x, (dt if strong else dt * 0.5).astype(np.float32), \
        A.astype(np.float32), Bm, Cm


SSD_DTYPES = ["bfloat16", "float32", "float32", "bfloat16", "bfloat16"]
# (B, S, H, P, N, chunk): chunk is the Pallas kernel's; the mirror's tiles
# are 64 rows whatever it is
SSD_CASES = [(2, 64, 3, 16, 16, 16), (1, 128, 2, 32, 32, 32),
             (2, 96, 4, 16, 64, 48), (1, 192, 2, 64, 16, 64),
             (1, 128, 2, 32, 128, 128)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
def test_ssd_subtile_mirror_vs_pallas_interpret_bf16(B, S, H, P, N, chunk):
    j, t = both(ssd_inputs(B * S + N, B, S, H, P, N), SSD_DTYPES)
    want = jax_ssd(*j, chunk=chunk, interpret=True)
    got = ref.ssd_subtile_ref(*t)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, P)
    assert rel(got, want) < BF16_REL


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
def test_ssd_subtile_mirror_equals_plain_in_float32(B, S, H, P, N, chunk,
                                                    strong):
    """Against the chunked plain version or, under strong decays, the
    sequential oracle: there the chunked form's cumsums over long chunks
    cancel in their differences."""
    _, t = both(ssd_inputs(11 + S, B, S, H, P, N, strong), ["float32"] * 5)
    want = (ref.ssd_scan_ref(*t) if strong
            else ref.ssd_chunked_ref(*t, chunk=chunk))
    assert rel(ref.ssd_subtile_ref(*t), want) < F32_REL


@pytest.mark.parametrize("S", [1, 65, 200])
def test_ssd_subtile_mirror_takes_ragged_sequences(S):
    """A ragged last tile is cut to the rows that exist: the result equals
    the sequential oracle on the same rows."""
    _, t = both(ssd_inputs(S, 2, S, 3, 16, 32), ["float32"] * 5)
    assert rel(ref.ssd_subtile_ref(*t), ref.ssd_scan_ref(*t)) < F32_REL


@pytest.mark.parametrize("strong", [False, True])
def test_ssd_subtile_mirror_bf16_at_zamba2_prefill(strong):
    """zamba2-1.2b's 512 prefill (B=4, H=64, P=N=64): the split bf16
    operands and the split copy of the state stay inside the card's bar
    against the float32 sequential oracle on the same inputs.  A CPU check
    of the design (``-s`` prints the errors), not a card number."""
    _, t = both(ssd_inputs(17, 4, 512, 64, 64, 64, strong), SSD_DTYPES)
    got = ref.ssd_subtile_ref(*t)
    x, dt, A, Bm, Cm = t
    want = ref.ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float())
    err = rel(got, want)
    print(f"ssd_subtile_ref bf16 vs float32 oracle, 4x512x64x64x64, "
          f"strong={strong}: rel {err:.3e}")
    assert err < BF16_REL
