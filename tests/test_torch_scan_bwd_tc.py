"""The plain mirrors of the bf16 scan backward kernels, on the CPU.

``ref.ssd_scan_bwd_tc_ref`` and ``ref.wkv6_scan_bwd_tc_ref`` follow the
kernels' chunk-parallel order (64-step chunk summaries, the scan over
chunks, then each chunk, or each 16-step sub-tile, on its own) and their
rounding points (split hi + lo operands, fp32 accumulators).  In float32
nothing is rounded, so each is held, at rel 1e-4 (max error over the
largest magnitude), to ``jax.grad`` of the reference's chunked scans
(``repro.kernels.ref.ssd_chunked_ref`` / ``wkv6_chunked_ref`` through
``repro.kernels.ops`` with ``use_pallas="never"``, which pads a ragged S)
and to PR 23's plain backwards ``ref.ssd_scan_bwd_ref`` /
``ref.wkv6_scan_bwd_ref``.  At clip-level WKV6 decays (w down to 1e-12)
the chunked forms' dw is no yardstick (see ``test_torch_scan_grad.py``):
there the mirror is held, with all its gradients, to autograd of the
sequential oracle on clip(w) in float64, at rel 1e-4.  In bf16 the mirror
is held to PR 23's plain backward on the same (rounded) inputs at rel 1e-2,
the bar the card holds the kernel to.  Cases cover S within one sub-tile,
within one chunk, over several chunks, ragged S, and every head size the
bf16 kernels take (WKV6 D 16 / 32 / 64; SSD P 16 / 32 / 64 x N 16 / 32 /
64 / 128).  The kernels themselves run on the card only
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref


def _rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = want.detach().double().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, B, S, H, P, N, decay="normal"):
    """x, dt, A, B, C, dy as float32 numpy.  "strong": dt = softplus(n), A =
    -exp(N(1.5, 1)), about e^-3 a step."""
    rng = np.random.default_rng(seed)
    strong = decay == "strong"
    x, dy = (rng.standard_normal((B, S, H, P), dtype=np.float32)
             for _ in range(2))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    dt = dt if strong else 0.5 * dt
    A = -np.exp(rng.standard_normal(H) + (1.5 if strong else 0.0))
    Bm, Cm = (rng.standard_normal((B, S, N), dtype=np.float32)
              for _ in range(2))
    return (x, dt.astype(np.float32), A.astype(np.float32), Bm, Cm, dy)


# (B, S, H, P, N, decay): S within one chunk, ragged, several chunks
SSD_JAX_CASES = {
    "S8_P16_N16": (2, 8, 3, 16, 16, "normal"),
    "S64_P32_N32": (1, 64, 2, 32, 32, "normal"),
    "S77_P64_N64": (1, 77, 2, 64, 64, "normal"),
    "S150_P16_N128": (1, 150, 2, 16, 128, "normal"),
    "S200_P32_N64_strong": (2, 200, 2, 32, 64, "strong"),
}


@pytest.mark.parametrize("case", sorted(SSD_JAX_CASES))
def test_ssd_mirror_matches_jax_grad(case):
    B, S, H, P, N, decay = SSD_JAX_CASES[case]
    args = _ssd_inputs(len(case), B, S, H, P, N, decay)
    x, dt, A, Bm, Cm, dy = (jnp.asarray(a) for a in args)
    _, vjp = jax.vjp(lambda *a: jops.ssd_scan(*a, chunk=64,
                                              use_pallas="never"),
                     x, dt, A, Bm, Cm)
    want = vjp(dy)
    got = ref.ssd_scan_bwd_tc_ref(*(torch.from_numpy(a) for a in args))
    for name, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w) < 1e-4, name


@pytest.mark.parametrize("P", [16, 32, 64])
@pytest.mark.parametrize("N", [16, 32, 64, 128])
@pytest.mark.parametrize("S", [16, 137])
def test_ssd_mirror_matches_the_plain_backward(S, N, P):
    """Every head size of the bf16 kernel, within one chunk and over three
    (ragged), against PR 23's plain backward in float32."""
    args = [torch.from_numpy(a) for a in
            _ssd_inputs(S + N + P, 1, S, 2, P, N)]
    got = ref.ssd_scan_bwd_tc_ref(*args)
    want = ref.ssd_scan_bwd_ref(*args, chunk=16)
    for name, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        assert _rel(g, w) < 1e-4, name


@pytest.mark.parametrize("S", [8, 130])
def test_ssd_bf16_mirror_holds_the_cards_bar(S):
    """bf16 inputs: the mirror's split products and bf16 outputs stay within
    the card's 1e-2 of the plain backward on the same inputs."""
    x, dt, A, Bm, Cm, dy = (torch.from_numpy(a) for a in
                            _ssd_inputs(S, 2, S, 4, 64, 64))
    x, Bm, Cm, dy = (t.to(torch.bfloat16) for t in (x, Bm, Cm, dy))
    got = ref.ssd_scan_bwd_tc_ref(x, dt, A, Bm, Cm, dy)
    want = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, chunk=16)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    for name, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        assert _rel(g, w) < 1e-2, name


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------

def _wkv_inputs(seed, B, S, H, D, decay="sigmoid"):
    """r, k, v, w, u, dy as float32 numpy.  "strong": w = exp(-exp(1 +
    2 n)), about a fifth of it at or below the clip at 1e-12."""
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal((B, S, H, D), dtype=np.float32)
                   for _ in range(4))
    n = rng.standard_normal((B, S, H, D))
    w = np.exp(-np.exp(1.0 + 2.0 * n)) if decay == "strong" \
        else 1.0 / (1.0 + np.exp(-(n + 2.0)))
    u = 0.1 * rng.standard_normal((H, D), dtype=np.float32)
    return r, k, v, w.astype(np.float32), u, dy


# (B, S, H, D): one sub-tile, one chunk (ragged), several chunks
WKV_JAX_CASES = {
    "S8_D16": (2, 8, 3, 16),
    "S45_D32": (1, 45, 2, 32),
    "S64_D64": (1, 64, 2, 64),
    "S150_D16": (2, 150, 2, 16),
    "S137_D64": (1, 137, 2, 64),
}


@pytest.mark.parametrize("case", sorted(WKV_JAX_CASES))
def test_wkv6_mirror_matches_jax_grad(case):
    B, S, H, D = WKV_JAX_CASES[case]
    args = _wkv_inputs(len(case), B, S, H, D)
    r, k, v, w, u, dy = (jnp.asarray(a) for a in args)
    _, vjp = jax.vjp(lambda *a: jops.wkv6_scan(*a, chunk=64,
                                               use_pallas="never",
                                               impl="chunked"),
                     r, k, v, w, u)
    want = vjp(dy)
    got = ref.wkv6_scan_bwd_tc_ref(*(torch.from_numpy(a) for a in args))
    for name, g, wt in zip("rkvwu", got, want):
        assert g.dtype == torch.float32
        assert _rel(g, wt) < 1e-4, name


@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 17, 64, 130])
def test_wkv6_mirror_matches_the_plain_backward(S, D):
    """Every head size of the bf16 kernel at S 1 (one row), 17 (a ragged
    second sub-tile), 64 (one chunk) and 130 (three, ragged) against PR 23's
    plain backward in float32."""
    args = [torch.from_numpy(a) for a in _wkv_inputs(S + D, 2, S, 2, D)]
    got = ref.wkv6_scan_bwd_tc_ref(*args)
    want = ref.wkv6_scan_bwd_ref(*args, chunk=16)
    for name, g, w in zip("rkvwu", got, want):
        assert _rel(g, w) < 1e-4, name


@pytest.mark.parametrize("S", [8, 37, 48, 150])
def test_wkv6_mirror_holds_the_sequential_oracle_at_the_clip(S):
    """At clip-level decays: the mirror against autograd of the sequential
    oracle on clip(w) in float64, every gradient at rel 1e-4 (dw read off
    the states, in factors <= 1: no decay inverted)."""
    r, k, v, w, u, dy = (torch.from_numpy(a) for a in
                         _wkv_inputs(S, 2, S, 2, 16, "strong"))
    assert float((w <= 1e-12).float().mean()) > 0.05  # the clip is reached
    xs = [t.double().requires_grad_() for t in (r, k, v, w, u)]
    ref.wkv6_scan_ref(xs[0], xs[1], xs[2], torch.clamp(xs[3], 1e-12, 1.0),
                      xs[4]).backward(dy.double())
    got = ref.wkv6_scan_bwd_tc_ref(r, k, v, w, u, dy)
    for name, g, x in zip("rkvwu", got, xs):
        assert _rel(g, x.grad) < 1e-4, name


def test_wkv6_mirror_keeps_the_clips_edges():
    """A decay exactly at the clip's edges (1.0 and float32's 1e-12) passes
    its gradient whole, as torch.clamp's does, and a decay past them none."""
    r, k, v, w, u, dy = (torch.from_numpy(a) for a in
                         _wkv_inputs(3, 1, 40, 2, 16))
    lo = float(np.float32(1e-12))
    w[0, 3, 0, :4] = 1.0
    w[0, 21, 1, 4:8] = lo
    w[0, 30, 0, 8:12] = 1e-20
    xs = [t.double().requires_grad_() for t in (r, k, v, w, u)]
    ref.wkv6_scan_ref(xs[0], xs[1], xs[2], torch.clamp(xs[3], lo, 1.0),
                      xs[4]).backward(dy.double())
    got = ref.wkv6_scan_bwd_tc_ref(r, k, v, w, u, dy)
    for name, g, x in zip("rkvwu", got, xs):
        assert _rel(g, x.grad) < 1e-4, name
    assert float(got[3][0, 21, 1, 4:8].abs().min()) > 0
    assert float(got[3][0, 30, 0, 8:12].abs().max()) == 0.0


@pytest.mark.parametrize("decay", ["sigmoid", "strong"])
def test_wkv6_bf16_mirror_holds_the_cards_bar(decay):
    r, k, v, w, u, dy = (torch.from_numpy(a) for a in
                         _wkv_inputs(7, 2, 77, 4, 64, decay))
    r, k, v, dy = (t.to(torch.bfloat16) for t in (r, k, v, dy))
    got = ref.wkv6_scan_bwd_tc_ref(r, k, v, w, u, dy)
    want = ref.wkv6_scan_bwd_ref(r, k, v, w, u, dy, chunk=16)
    assert [g.dtype for g in got] == [x.dtype for x in want]
    for name, g, x in zip("rkvwu", got, want):
        assert _rel(g, x) < 1e-2, name
