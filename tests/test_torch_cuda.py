"""Tests of the port that need the card: the CUDA flash-attention kernel
against its plain version, and the serving path launching it.  They carry
the ``cuda`` marker and skip without a card; on the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import ref
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.cuda
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (2e-5, 1e-3), "bfloat16": (2e-2, 1e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(dev, dtype, B, S, T, H, KV, D, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 .to(dev, TDT[dtype])
                 for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))


@pytest.mark.parametrize("B,S,T,H,KV,D,dtype,causal,window,softcap,q_pos0", [
    (4, 512, 512, 4, 4, 64, "bfloat16", True, None, None, 0),
    (2, 200, 200, 4, 4, 64, "bfloat16", True, None, None, 0),
    (1, 33, 70, 4, 1, 64, "float32", False, None, None, 0),
    (2, 300, 300, 4, 2, 32, "float32", True, 64, 30.0, 0),
    (1, 48, 64, 4, 4, 64, "float32", True, None, None, 16),
    (1, 130, 130, 2, 1, 16, "float32", True, None, None, 0),
    (1, 129, 129, 4, 2, 128, "bfloat16", True, None, None, 0),
    (2, 70, 200, 4, 4, 64, "bfloat16", False, 50, None, 100),
])
def test_kernel_vs_plain(cuda_device, B, S, T, H, KV, D, dtype, causal,
                         window, softcap, q_pos0):
    q, k, v = _qkv(cuda_device, dtype, B, S, T, H, KV, D)
    kw = dict(causal=causal, window=window, softcap_val=softcap, q_pos0=q_pos0)
    before = fak.launches
    got = fak.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fak.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_kernel_refuses_what_it_cannot_take(cuda_device):
    q, k, v = _qkv(cuda_device, "float32", 1, 8, 8, 2, 2, 48)
    with pytest.raises(ValueError, match="head dim"):
        fak.flash_attention(q, k, v)
    q, k, v = _qkv(cuda_device, "float32", 1, 8, 8, 2, 2, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fak.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)


@torch.inference_mode()
def test_serve_launches_kernel_per_layer_and_matches_plain(cuda_device):
    cfg = registry.get_config("jag-surrogate")
    params = lm.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                            cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(1))
    eng = ServeEngine(cfg, params, max_len=128)
    before = fak.launches
    out = eng.generate(toks, 4)
    assert out.shape == (2, 4)
    assert fak.launches - before == cfg.n_layers
    lk, _ = eng.prefill_fn(params, toks)
    plain = ServeEngine(cfg.replace(use_pallas="never"), params, max_len=128)
    lp, _ = plain.prefill_fn(params, toks)
    lk, lp = lk.float(), lp.float()
    assert torch.isfinite(lk).all()
    assert float((lk - lp).abs().max() / lp.abs().max()) < 5e-2
