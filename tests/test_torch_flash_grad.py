"""Gradients of the port's flash attention against the JAX reference, on
the CPU.

The reference's attention gradient is ``jax.grad`` through its plain path
(``repro.kernels.ref.flash_attention_ref``: the Pallas kernel has no VJP).
The port's wrapper on a CPU tensor runs its plain version under PyTorch's
autograd; on the card its gradient is the CUDA backward kernel, whose plain
version ``ref.flash_attention_bwd_ref`` (with ``flash_attention_lse_ref``,
the forward's row log-sum-exp) is held here to the port's autograd; the
mirror of the bf16 kernel's rounding is tested in test_torch_flash_bwd_tc.py.
The kernel itself is checked on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Inputs and the output gradient are made with numpy from a
seed and handed to both frameworks.  float32: rel 1e-4 against JAX (max
error over the largest magnitude), 1e-5 between the port's two forms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fak


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(seed, B, S, T, H, KV, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D), (B, S, H, D))]


# (B, S, T, H, KV, D, causal, window, softcap)
CASES = {
    "causal": (2, 64, 64, 4, 4, 32, True, None, None),
    "non_causal": (2, 64, 64, 4, 4, 32, False, None, None),
    "window16_softcap30": (1, 64, 64, 4, 4, 32, True, 16, 30.0),
    "gqa_4_2": (2, 64, 64, 4, 2, 32, True, None, None),
    "D32": (1, 40, 40, 2, 2, 32, True, None, None),
    "D64": (1, 40, 40, 2, 2, 64, True, None, None),
    "ragged_48": (2, 48, 48, 4, 2, 32, True, None, None),
    "ragged_100": (1, 100, 100, 4, 4, 64, True, None, None),
}


def _port_grads(q, k, v, do, kw):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, **kw)
    out.backward(torch.from_numpy(do))
    return out.detach(), (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_grads_match_jax_grad_of_the_reference(case):
    B, S, T, H, KV, D, causal, window, softcap = CASES[case]
    q, k, v, do = _inputs(len(case), B, S, T, H, KV, D)
    kw = dict(causal=causal, window=window, softcap_val=softcap)
    want_out, vjp = jax.vjp(
        lambda a, b, c: jref.flash_attention_ref(a, b, c, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    out, got = _port_grads(q, k, v, do, kw)
    assert _rel(out, want_out) < 1e-4
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w) < 1e-4, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_plain_version_matches_autograd(case):
    """ref.flash_attention_bwd_ref from the forward's output and
    flash_attention_lse_ref's log-sum-exp is the port's autograd gradient;
    the log-sum-exp is the logits' (from the O(S^2) oracle's masked,
    softcapped, scaled logits)."""
    B, S, T, H, KV, D, causal, window, softcap = CASES[case]
    q, k, v, do = _inputs(100 + len(case), B, S, T, H, KV, D)
    kw = dict(causal=causal, window=window, softcap_val=softcap)
    out, want = _port_grads(q, k, v, do, kw)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o2, lse = ref.flash_attention_lse_ref(tq, tk, tv, **kw, block_k=32)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert _rel(o2, out) < 1e-5
    # the oracle's logits, (B, KV, g, S, T) -> (B, H, S, T)
    g = H // KV
    logits = torch.einsum("bskgd,btkd->bkgst", tq.reshape(B, S, KV, g, D),
                          tk) / D ** 0.5
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    qpos, kpos = torch.arange(S)[:, None], torch.arange(T)[None, :]
    keep = ref._mask(qpos, kpos, causal, window)
    logits = torch.where(keep, logits, ref.NEG_INF).reshape(B, H, S, T)
    assert _rel(lse, torch.logsumexp(logits, -1)) < 1e-5
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o2, tdo, lse, **kw,
                                      block_k=32)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        assert _rel(a, b) < 1e-5, name


@pytest.mark.parametrize("case", ["causal", "window16_softcap30", "gqa_4_2"])
def test_backward_plain_version_in_bf16(case):
    """The plain backward on bf16 inputs (and the bf16 forward's output)
    stays within rel 2e-2 of the float32 form, the bar the card holds the
    bf16 kernel to against it (the kernel's own rounding points are
    mirrored by ref.flash_attention_bwd_tc_ref: test_torch_flash_bwd_tc.py)."""
    B, S, T, H, KV, D, causal, window, softcap = CASES[case]
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(7, B, S, T, H, KV, D))
    kw = dict(causal=causal, window=window, softcap_val=softcap)
    o32, lse32 = ref.flash_attention_lse_ref(q, k, v, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o32, do, lse32, **kw)
    qb, kb, vb, dob = (t.to(torch.bfloat16) for t in (q, k, v, do))
    ob, lseb = ref.flash_attention_lse_ref(qb, kb, vb, **kw)
    got = ref.flash_attention_bwd_ref(qb, kb, vb, ob, dob, lseb, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        assert _rel(a, b) < 2e-2, name


def test_backward_refuses_what_its_kernel_cannot_take():
    q = torch.zeros(1, 40, 2, 32)
    k = torch.zeros(1, 40, 2, 32)
    with pytest.raises(ValueError, match="q_pos0"):
        fak.check_backward_args(q, k, q_pos0=8)
    with pytest.raises(ValueError, match="no key"):
        fak.check_backward_args(q, k[:, :20], window=8)
    fak.check_backward_args(q, k, window=8)
    fak.check_backward_args(q, k[:, :20])


def test_scan_wrappers_take_grad_and_nothing_refuses_it():
    """WKV6 and SSD have their backward kernels (autograd Functions on a
    CUDA tensor: tests/test_torch_cuda.py); on the CPU the wrappers'
    outputs carry autograd's graph through the plain versions, and neither
    the build module nor launch.train keeps a refusal of grad."""
    from repro_torch.launch import train as launch_train
    assert not hasattr(_build, "refuse_grad")
    assert not hasattr(_build, "no_backward")
    assert not hasattr(launch_train, "_NO_BACKWARD")
    rng = np.random.default_rng(0)
    r, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 16),
                                                    dtype=np.float32))
               .requires_grad_() for _ in range(3))
    w = torch.full((1, 8, 2, 16), 0.9, requires_grad=True)
    u = torch.zeros(2, 16, requires_grad=True)
    y = ops.wkv6_scan(r, k, v, w, u, chunk=8)
    assert y.grad_fn is not None
    y.sum().backward()
    assert all(t.grad is not None for t in (r, k, v, w, u))
