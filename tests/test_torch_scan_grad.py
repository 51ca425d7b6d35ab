"""Gradients of the port's scans and of D-192 attention against the JAX
reference, on the CPU.

The reference's Pallas scans have no VJP: it differentiates its plain paths
(``repro.kernels.ops.wkv6_scan`` / ``ssd_scan`` with ``use_pallas="never"``,
``repro.kernels.ref.flash_attention_ref``) with ``jax.grad``.  On the card
the port's gradients are its backward kernels, whose plain versions are
``ref.wkv6_scan_bwd_ref`` and ``ref.ssd_scan_bwd_ref`` (explicit chunked
backwards, no autograd) and ``ref.flash_attention_bwd_ref``; on the CPU
they are PyTorch's autograd of the plain forwards.  Both are held here to
``jax.grad``, on inputs and output gradients made with numpy from a seed.

Tolerances (max error over the largest magnitude), float32: rel 1e-4.
Where the decays reach the 1e-12 clip (log -27.6 a step) the chunked
forms take differences of long cumsums, which lose ~1e-6 of the exponent
for each unit of its size (ROADMAP's WKV trap): those cases hold dr, dk,
dv and du at 1e-3 against ``jax.grad`` of the reference's chunked form.
Its dw is not a yardstick there: autograd of either framework's chunked
form reads dw = d(loss)/d(log w) / w, where the first factor is those
cumsums' rounding and w ~ 1e-11 (the port's and JAX's disagree by O(1),
and both give step 0, whose decay multiplies the zero initial state, a
nonzero dw).  The plain backward reads dw off the states, and is held
there, with all its gradients, at 1e-4 to autograd of the sequential
oracle in float64.  The
kernels themselves run on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flops, ops, ref
from repro_torch.kernels import ssd_scan as ssdk
from repro_torch.kernels import wkv6_scan as wkvk


def _rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------

# (B, S, H, D, decay, impl, chunk): S = 45 and 40 are padded with w = 1
WKV_CASES = {
    "chunked_S64": (2, 64, 3, 16, "sigmoid", "chunked", 32),
    "chunked_ragged_S45": (1, 45, 2, 16, "sigmoid", "chunked", 16),
    "chunked_D64_S33": (1, 33, 2, 64, "sigmoid", "chunked", 64),
    "chunked_clip": (2, 48, 2, 16, "strong", "chunked", 16),
    "blocked_S64": (2, 64, 2, 16, "sigmoid", "blocked", 32),
    "blocked_ragged_S40": (1, 40, 2, 16, "sigmoid", "blocked", 32),
}


def _wkv_inputs(seed, B, S, H, D, decay):
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


def _wkv_jax_grads(args, impl, chunk):
    r, k, v, w, u, dy = (jnp.asarray(a) for a in args)
    y, vjp = jax.vjp(lambda *a: jops.wkv6_scan(
        *a, chunk=chunk, use_pallas="never", impl=impl), r, k, v, w, u)
    return y, vjp(dy)


def _tol(decay):
    return 1e-3 if decay == "strong" else 1e-4


@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_wkv6_autograd_matches_jax_grad(case):
    B, S, H, D, decay, impl, chunk = WKV_CASES[case]
    args = _wkv_inputs(len(case), B, S, H, D, decay)
    want_y, want = _wkv_jax_grads(args, impl, chunk)
    ts = [torch.from_numpy(a).requires_grad_() for a in args[:5]]
    y = ops.wkv6_scan(*ts, chunk=chunk, impl=impl)
    y.backward(torch.from_numpy(args[5]))
    assert _rel(y, want_y) < _tol(decay)
    for name, t, w in zip("rkvwu", ts, want):
        if name == "w" and decay == "strong":
            continue  # no yardstick at the clip: see the module's notes
        assert _rel(t.grad, w) < _tol(decay), name


@pytest.mark.parametrize("case", sorted(c for c in WKV_CASES
                                        if WKV_CASES[c][5] == "chunked"))
def test_wkv6_plain_backward_matches_jax_grad(case):
    """ref.wkv6_scan_bwd_ref (any S: it pads with w = 1 inside) against
    jax.grad of the reference's chunked scan."""
    B, S, H, D, decay, impl, chunk = WKV_CASES[case]
    args = _wkv_inputs(100 + len(case), B, S, H, D, decay)
    _, want = _wkv_jax_grads(args, impl, chunk)
    got = ref.wkv6_scan_bwd_ref(*(torch.from_numpy(a) for a in args),
                                chunk=chunk)
    for name, g, w in zip("rkvwu", got, want):
        assert g.dtype == torch.float32
        if name == "w" and decay == "strong":
            # held to the sequential oracle below
            assert float(g[:, 0].abs().max()) == 0.0  # S_0 = 0
            continue
        assert _rel(g, w) < _tol(decay), name


@pytest.mark.parametrize("S,chunk", [(48, 16), (37, 16), (16, 64)])
def test_wkv6_plain_backward_holds_the_sequential_oracle_at_the_clip(S,
                                                                    chunk):
    """At clip-level decays: the plain backward against autograd of the
    sequential oracle on clip(w) in float64, rel 1e-4."""
    r, k, v, w, u, dy = (torch.from_numpy(a) for a in
                         _wkv_inputs(S, 2, S, 2, 16, "strong"))
    assert float((w <= 1e-12).float().mean()) > 0.1
    xs = [t.double().requires_grad_() for t in (r, k, v, w, u)]
    y = ref.wkv6_scan_ref(xs[0], xs[1], xs[2],
                          torch.clamp(xs[3], 1e-12, 1.0), xs[4])
    y.backward(dy.double())
    got = ref.wkv6_scan_bwd_ref(r, k, v, w, u, dy, chunk=chunk)
    for name, g, x in zip("rkvwu", got, xs):
        assert _rel(g, x.grad) < 1e-4, name


def test_wkv6_clip_edges_take_torch_clamps_gradient():
    """A decay exactly at the clip's edge (1.0, 1e-12) passes its gradient
    whole, as torch.clamp's does: the plain backward equals autograd of the
    sequential oracle on torch.clamp(w) (float64) there, at rel 1e-4.
    jnp.clip splits a tie between its two branches and hands back half (at
    w = 1, where the reference's chunked dw is no rounding artefact); the
    model's decays exp(-exp(.)) lie strictly inside, and the padding's
    w = 1 is cut off with its gradient."""
    r, k, v, w, u, dy = (torch.from_numpy(a) for a in
                         _wkv_inputs(3, 1, 16, 2, 16, "sigmoid"))
    lo = float(np.float32(1e-12))  # the clip's edge as float32 reads it
    w[0, 3, 0, :4] = 1.0
    w[0, 5, 1, 4:8] = lo
    xs = [t.double().requires_grad_() for t in (r, k, v, w, u)]
    ref.wkv6_scan_ref(xs[0], xs[1], xs[2], torch.clamp(xs[3], lo, 1.0),
                      xs[4]).backward(dy.double())
    got = ref.wkv6_scan_bwd_ref(r, k, v, w, u, dy, chunk=16)
    for name, g, x in zip("rkvwu", got, xs):
        assert _rel(g, x.grad) < 1e-4, name
    assert float(got[3][0, 5, 1, 4:8].abs().min()) > 0
    _, jg = _wkv_jax_grads((r.numpy(), k.numpy(), v.numpy(), w.numpy(),
                            u.numpy(), dy.numpy()), "chunked", 16)
    np.testing.assert_allclose(np.asarray(jg[3])[0, 3, 0, :4],
                               0.5 * got[3][0, 3, 0, :4].numpy(), rtol=1e-3)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

# (B, S, H, P, N, decay, chunk): S = 45 is padded with x = dt = 0
SSD_CASES = {
    "S64": (2, 64, 3, 8, 16, "normal", 32),
    "ragged_S45": (1, 45, 2, 16, 16, "normal", 16),
    "P16_N32_S24": (1, 24, 2, 16, 32, "normal", 8),
    "strong": (2, 48, 2, 8, 16, "strong", 16),
}


def _ssd_inputs(seed, B, S, H, P, N, decay):
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


def _ssd_jax_grads(args, chunk):
    x, dt, A, Bm, Cm, dy = (jnp.asarray(a) for a in args)
    y, vjp = jax.vjp(lambda *a: jops.ssd_scan(
        *a, chunk=chunk, use_pallas="never"), x, dt, A, Bm, Cm)
    return y, vjp(dy)


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_autograd_matches_jax_grad(case):
    B, S, H, P, N, decay, chunk = SSD_CASES[case]
    args = _ssd_inputs(len(case), B, S, H, P, N, decay)
    want_y, want = _ssd_jax_grads(args, chunk)
    ts = [torch.from_numpy(a).requires_grad_() for a in args[:5]]
    y = ops.ssd_scan(*ts, chunk=chunk)
    y.backward(torch.from_numpy(args[5]))
    assert _rel(y, want_y) < 1e-4
    for name, t, w in zip(("x", "dt", "A", "B", "C"), ts, want):
        assert _rel(t.grad, w) < 1e-4, name


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_plain_backward_matches_jax_grad(case):
    """ref.ssd_scan_bwd_ref (any S: it pads with x = dt = 0 inside)
    against jax.grad of the reference's chunked scan; dB and dC sum over
    the heads, dA over b and t."""
    B, S, H, P, N, decay, chunk = SSD_CASES[case]
    args = _ssd_inputs(100 + len(case), B, S, H, P, N, decay)
    _, want = _ssd_jax_grads(args, chunk)
    got = ref.ssd_scan_bwd_ref(*(torch.from_numpy(a) for a in args),
                               chunk=chunk)
    for name, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        assert _rel(g, w) < 1e-4, name


# ---------------------------------------------------------------------------
# the wrappers and the dry run's counted backward
# ---------------------------------------------------------------------------

class _Counter:
    def __init__(self):
        self.kernel_flops = {}

    def add_kernel_flops(self, name, n):
        self.kernel_flops[name] = self.kernel_flops.get(name, 0.0) + n


def test_scan_wrappers_on_the_cpu_give_the_plain_backward():
    r, k, v, w, u, dy = (torch.from_numpy(a) for a in
                         _wkv_inputs(5, 1, 20, 2, 16, "sigmoid"))
    for a, b in zip(wkvk.wkv6_scan_bwd(r, k, v, w, u, dy),
                    ref.wkv6_scan_bwd_ref(r, k, v, w, u, dy)):
        assert torch.equal(a, b)
    x, dt, A, Bm, Cm, dy = (torch.from_numpy(a) for a in
                            _ssd_inputs(5, 1, 20, 2, 8, 16, "normal"))
    for a, b in zip(ssdk.ssd_scan_bwd(x, dt, A, Bm, Cm, dy),
                    ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scan", ["wkv6", "ssd"])
def test_counted_scans_count_their_backward_and_keep_autograds_gradient(
        scan):
    """Under a FLOP counter (the dry run) a scan under grad runs through
    ops._PlainScanFn: its forward and its backward are counted as the
    kernels' (scan_flops, 6 state products a token and head backward, over
    the padded rows the kernels get: S a multiple of the chunk here), and
    its gradients are the plain backward's, equal to autograd's."""
    if scan == "wkv6":
        *args, dy = (torch.from_numpy(a) for a in
                     _wkv_inputs(9, 1, 32, 2, 16, "sigmoid"))
        fn = lambda *a: ops.wkv6_scan(*a, chunk=16)  # noqa: E731
        n = args[0].shape[-1]
    else:
        *args, dy = (torch.from_numpy(a) for a in
                     _ssd_inputs(9, 1, 32, 2, 8, 16, "normal"))
        fn = lambda *a: ops.ssd_scan(*a, chunk=16)  # noqa: E731
        n = args[3].shape[-1]
    plain = [a.clone().requires_grad_() for a in args]
    fn(*plain).backward(dy)
    counter = _Counter()
    xs = [a.clone().requires_grad_() for a in args]
    with flops.counting(counter):
        y = fn(*xs)
        y.backward(dy)
    fwd = flops.scan_flops(args[0], n)
    assert counter.kernel_flops == {f"{scan}_scan": fwd,
                                    f"{scan}_scan_bwd": 3 * fwd}
    for a, b in zip(xs, plain):
        assert _rel(a.grad, b.grad) < 1e-5


# rwkv6-3b's and zamba2-1.2b's heads at the reference's train_4k length
SCRATCH_SHAPES = {"wkv6": (1, 4096, 40, 64), "ssd": (1, 4096, 64, 64)}


def _meta_scan_args(scan):
    """A scan's inputs on the meta device, bf16 where the model has them,
    requiring grad, and its output gradient."""
    B, S, H, D = SCRATCH_SHAPES[scan]
    bf, f32 = (dict(dtype=t, device="meta") for t in (torch.bfloat16,
                                                      torch.float32))
    if scan == "wkv6":
        args = [torch.empty(B, S, H, D, **bf) for _ in range(3)] + [
            torch.empty(B, S, H, D, **f32), torch.empty(H, D, **f32)]
    else:
        args = [torch.empty(B, S, H, D, **bf), torch.empty(B, S, H, **f32),
                torch.empty(H, **f32), torch.empty(B, S, D, **bf),
                torch.empty(B, S, D, **bf)]
    return ([a.requires_grad_() for a in args],
            torch.empty(B, S, H, D, **bf))


def _scratch(scan, args):
    return (wkvk.bwd_scratch(args[0]) if scan == "wkv6"
            else ssdk.bwd_scratch(args[0], args[3]))


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("scan", ["wkv6", "ssd"])
def test_backward_scratch_is_saved_states_a_chunk(scan):
    """The bf16 backward kernels keep, for every 64-step chunk, the state
    entering it and the gradient leaving it (each 2x the bf16 input's bytes
    at D = P = N = 64: 4 D^2 bytes for 64 tokens of 2 D) and its decay, and
    no segment scratch; where S fits one chunk, none of these.  SSD adds
    dB / dC partial rows a group of heads (16 heads a block at 1 x 4096: a
    sixteenth of the per-head rows of PR 23's kernel), WKV6 du partial sums
    a 16-step sub-tile."""
    (x, *rest), _ = _meta_scan_args(scan)
    args = [x] + rest
    B, S, H, D = x.shape
    scratch = _scratch(scan, args)
    mod = wkvk if scan == "wkv6" else ssdk
    hst, gst, dec = scratch[-3:]
    assert mod.CHUNK == 64
    assert hst.shape == gst.shape == (B, H, S // 64, D, D)
    assert _nbytes([hst]) == _nbytes([gst]) == 2 * _nbytes([x])
    assert dec.shape == ((B, H, S // 64, D) if scan == "wkv6"
                         else (B, H, S // 64))
    short = _scratch(scan, [x[:, :64]] + [t[:, :64] if t.dim() > 2 and
                                          t.shape[1] == S else t
                                          for t in rest])
    assert all(t.numel() == 0 for t in short[-3:])
    if scan == "ssd":
        hg = ssdk.heads_a_block(B, S, H)
        assert hg == 16
        assert [t.shape for t in scratch[1:3]] == [(B, S, H // hg, D)] * 2
        assert _nbytes(scratch[1:3]) * hg == 4 * _nbytes([x])
        assert scratch[0].shape == (B, S // 64, H)
    else:
        assert scratch[0].shape == (B, S // wkvk.SUB, H, D)
    # h_in and g_out (4x), plus WKV6's du partials (0.13x) or SSD's dB / dC
    # partial rows a group (0.25x)
    assert _nbytes(scratch) < (4.2 if scan == "wkv6" else 4.3) * _nbytes([x])


# (B, S) -> the head group timed fastest of every divisor of zamba2-1.2b's
# 64 heads on an H100 (tools/scan_bwd_variants.py --heads; PERF.md §6)
FASTEST_HEAD_GROUP = {(1, 8): 1, (8, 128): 4, (1, 4096): 16, (4, 1024): 16,
                      (16, 512): 32, (16, 4096): 64}


@pytest.mark.parametrize("B,S", sorted(FASTEST_HEAD_GROUP))
def test_heads_a_block_picks_the_fastest_timed_group(B, S):
    """SSD's bf16 backward takes ``heads_a_block`` heads a block; at each
    shape timed on the card that is the fastest group, and the scratch
    holds dB / dC partial rows for H / hg groups (none for one group)."""
    hg = ssdk.heads_a_block(B, S, 64)
    assert hg == FASTEST_HEAD_GROUP[B, S]
    x = torch.empty(B, S, 64, 64, dtype=torch.bfloat16, device="meta")
    rows = ssdk.bwd_scratch(x, torch.empty(B, S, 64, dtype=torch.bfloat16,
                                           device="meta"))[1:3]
    want = (B, S, 64 // hg, 64) if hg < 64 else (0,)
    assert [tuple(t.shape) for t in rows] == [want] * 2


@pytest.mark.parametrize("scan", ["wkv6", "ssd"])
def test_dry_run_backward_holds_the_kernels_scratch(scan):
    """Under the dry run's counter (meta tensors, train_4k's S) the counted
    backward holds what the kernel's call holds: the gradients and the
    kernel's scratch, live at once."""
    from repro_torch.launch.dryrun import LocalCounter
    args, dy = _meta_scan_args(scan)
    counter = LocalCounter({a.untyped_storage()._cdata for a in args})
    with counter, flops.counting(counter):
        if scan == "wkv6":
            y = ops.wkv6_scan(*args, chunk=64)
        else:
            y = ops.ssd_scan(*args, chunk=128)
        fwd_peak = counter.peak
        y.backward(dy)
    want = _nbytes(_scratch(scan, args)) + _nbytes(args)
    assert counter.peak >= want > fwd_peak
    assert all(a.grad is not None and a.grad.shape == a.shape and
               a.grad.dtype == a.dtype for a in args)


# ---------------------------------------------------------------------------
# flash attention at D 192 (deepseek's MLA)
# ---------------------------------------------------------------------------

# (B, S, T, H, KV, causal)
D192_CASES = {"causal": (2, 40, 40, 4, 4, True),
              "gqa_4_2": (1, 33, 33, 4, 2, True),
              "cross_S20_T50": (1, 20, 50, 2, 1, False)}


@pytest.mark.parametrize("case", sorted(D192_CASES))
def test_d192_plain_backward_matches_jax_grad(case):
    """ref.flash_attention_bwd_ref at D 192, from flash_attention_lse_ref's
    output and log-sum-exp, against jax.grad of the reference's
    flash_attention_ref; and the port's autograd through ops."""
    B, S, T, H, KV, causal = D192_CASES[case]
    rng = np.random.default_rng(len(case))
    q, do = (rng.standard_normal((B, S, H, 192), dtype=np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, T, KV, 192), dtype=np.float32)
            for _ in range(2))
    want_out, vjp = jax.vjp(
        lambda a, b, c: jref.flash_attention_ref(a, b, c, causal=causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = ref.flash_attention_lse_ref(tq, tk, tv, causal=causal)
    assert _rel(out, want_out) < 1e-4
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, tdo, lse,
                                      causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w) < 1e-4, name
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    ops.flash_attention(*xs, causal=causal).backward(tdo)
    for name, x, w in zip(("dq", "dk", "dv"), xs, want):
        assert _rel(x.grad, w) < 1e-4, name
