"""The plain mirror of the bf16 tensor-core backward kernel
(``ref.flash_attention_bwd_tc_ref``) against the JAX reference, on the CPU.

The kernel rounds P to bf16 before Pᵀ·dO and dS to bf16 before dS·K and
dSᵀ·Q, with fp32 logits of the bf16 q and k scaled after the product; the
mirror does the same in plain PyTorch, and the card holds the kernel to it
(tests/test_torch_cuda.py, chip_smoke.py).  Here the mirror is held to
``jax.grad`` of ``repro.kernels.ref.flash_attention_ref`` in bf16 at rel
2e-2 (max error over the largest magnitude; bf16 keeps 8 mantissa bits),
and on float32 inputs, where it rounds nothing, to the plain backward
``ref.flash_attention_bwd_ref`` at 1e-5.  Inputs and the output gradient
are made with numpy from a seed and handed to both frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

from test_torch_flash_grad import CASES, _inputs, _rel

BF16_REL = 2e-2
F32_REL = 1e-5


def _port(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tc_mirror_matches_jax_grad_in_bf16(case):
    B, S, T, H, KV, D, causal, window, softcap = CASES[case]
    arrs = _inputs(200 + len(case), B, S, T, H, KV, D)
    kw = dict(causal=causal, window=window, softcap_val=softcap)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs)
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, **kw),
                     jq, jk, jv)
    want = vjp(jdo)
    q, k, v, do = _port(arrs, torch.bfloat16)
    o, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    got = ref.flash_attention_bwd_tc_ref(q, k, v, o, do, lse, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g, np.asarray(w.astype(jnp.float32))) < BF16_REL, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_tc_mirror_equals_plain_in_float32(case):
    """On float32 inputs the mirror rounds nothing: it is the plain
    backward, here in the kernel's 64-key blocks against one block."""
    B, S, T, H, KV, D, causal, window, softcap = CASES[case]
    q, k, v, do = _port(_inputs(300 + len(case), B, S, T, H, KV, D),
                        torch.float32)
    kw = dict(causal=causal, window=window, softcap_val=softcap)
    o, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    got = ref.flash_attention_bwd_tc_ref(q, k, v, o, do, lse, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w) < F32_REL, name


def test_tc_mirror_rounds_p_and_ds_in_bf16():
    """The mirror is not the plain backward on bf16 inputs: rounding P
    moves dv, rounding dS moves dq and dk, each by more than nothing and
    less than the bf16 bar."""
    q, k, v, do = _port(_inputs(5, 1, 64, 64, 2, 2, 32), torch.bfloat16)
    o, lse = ref.flash_attention_lse_ref(q, k, v)
    got = ref.flash_attention_bwd_tc_ref(q, k, v, o, do, lse)
    plain = ref.flash_attention_bwd_ref(q, k, v, o, do, lse)
    for name, a, b in zip(("dq", "dk", "dv"), got, plain):
        assert float((a.float() - b.float()).abs().max()) > 0, name
        assert _rel(a, b.float()) < BF16_REL, name
