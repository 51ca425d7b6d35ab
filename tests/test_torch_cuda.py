"""Tests of the port that need the card: each CUDA kernel (flash attention,
the WKV6 and SSD scans) against its plain version, and the serving paths
launching them.  They carry
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
from repro_torch.kernels import ssd_scan as ssdk
from repro_torch.kernels import wkv6_scan as wkvk
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.cuda
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (2e-5, 1e-3), "bfloat16": (2e-2, 1e-2)}
# scans: max |kernel - plain| / max |plain|; bf16 outputs are rounded to 8
# mantissa bits and summed in another order
SCAN_REL = {"float32": 1e-4, "bfloat16": 1e-2}


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
    # bf16 on the tensor cores: every feature and ragged edge of the tiling
    (2, 300, 300, 4, 2, 32, "bfloat16", True, 64, 30.0, 0),
    (1, 130, 130, 2, 1, 16, "bfloat16", True, None, None, 0),
    (2, 200, 200, 8, 2, 128, "bfloat16", True, None, None, 0),
    (1, 33, 70, 4, 1, 64, "bfloat16", False, None, None, 0),
    (2, 1, 101, 4, 4, 64, "bfloat16", True, None, None, 100),
    (1, 45, 83, 4, 2, 64, "bfloat16", False, None, None, 0),
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


def _rel(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max())


def _wkv_inputs(dev, dtype, B, S, H, D, seed=2, strong=False):
    """``strong``: w = exp(-exp(N(1, 2))), which reaches the clip at 1e-12
    as rwkv6-3b's data-dependent decays can."""
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D), dtype=np.float32))
               .to(dev, TDT[dtype]) for _ in range(3))
    n = torch.from_numpy(rng.standard_normal((B, S, H, D), dtype=np.float32))
    w = (torch.exp(-torch.exp(1.0 + 2.0 * n)) if strong
         else torch.sigmoid(n + 2.0)).to(dev)
    u = torch.from_numpy(rng.standard_normal((H, D), dtype=np.float32) * 0.1).to(dev)
    return r, k, v, w, u


def _ssd_inputs(dev, dtype, B, S, H, P, N, seed=3, strong=False):
    """``strong``: dt = softplus(N(0,1)) and A = -exp(N(1.5,1)), about e^-3
    a step, where acs differences cancel."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, S, H, P), dtype=np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, H), dtype=np.float32)))
    dt = dt if strong else dt * 0.5
    A = -torch.exp(torch.from_numpy(rng.standard_normal(H, dtype=np.float32))
                   + (1.5 if strong else 0.0))
    Bm = torch.from_numpy(rng.standard_normal((B, S, N), dtype=np.float32))
    Cm = torch.from_numpy(rng.standard_normal((B, S, N), dtype=np.float32))
    return (x.to(dev, TDT[dtype]), dt.to(dev), A.to(dev), Bm.to(dev, TDT[dtype]),
            Cm.to(dev, TDT[dtype]))


@pytest.mark.parametrize("B,S,H,D,dtype,chunk", [
    (4, 512, 40, 64, "bfloat16", 64),   # rwkv6-3b prefill
    (4, 256, 40, 64, "bfloat16", 64),   # 200 tokens padded to 256
    (4, 32, 40, 64, "bfloat16", 32),
    (2, 128, 4, 64, "float32", 64),
    (1, 96, 3, 16, "float32", 32),
    (2, 100, 4, 32, "float32", 100),    # ragged against the 64-row tile
])
def test_wkv6_kernel_vs_plain(cuda_device, B, S, H, D, dtype, chunk):
    r, k, v, w, u = _wkv_inputs(cuda_device, dtype, B, S, H, D)
    before = wkvk.launches
    got = wkvk.wkv6_scan(r, k, v, w, u, chunk=chunk)
    torch.cuda.synchronize()
    assert wkvk.launches == before + 1
    want = ref.wkv6_chunked_ref(r, k, v, w, u, chunk=chunk)
    assert got.dtype == r.dtype and got.shape == r.shape
    assert _rel(got, want) < SCAN_REL[dtype]


@pytest.mark.parametrize("B,S,H,D,dtype", [
    (4, 512, 40, 64, "bfloat16"),   # rwkv6-3b's prefill shape
    (2, 1, 4, 64, "bfloat16"),
    (2, 15, 4, 64, "bfloat16"),     # one ragged sub-tile
    (2, 17, 4, 64, "bfloat16"),     # a full sub-tile and one row
    (1, 77, 40, 64, "bfloat16"),
    (2, 50, 4, 16, "float32"),
    (2, 50, 4, 32, "float32"),
])
def test_wkv6_kernel_strong_decays(cuda_device, B, S, H, D, dtype):
    r, k, v, w, u = _wkv_inputs(cuda_device, dtype, B, S, H, D, strong=True)
    assert float(w.min()) < 1e-12
    got = wkvk.wkv6_scan(r, k, v, w, u, chunk=S)
    # the sequential oracle: the chunked form's long cumsums lose ~1e-4 to
    # cancellation under such decays
    want = ref.wkv6_scan_ref(r, k, v, w, u)
    assert got.dtype == r.dtype and got.shape == r.shape
    assert _rel(got, want) < SCAN_REL[dtype]


@pytest.mark.parametrize("B,S,H,P,N,dtype,chunk", [
    (4, 512, 64, 64, 64, "bfloat16", 256),  # zamba2-1.2b prefill
    (4, 200, 64, 64, 64, "bfloat16", 200),  # ragged last tile
    (4, 32, 64, 64, 64, "bfloat16", 32),
    (2, 128, 4, 64, 64, "float32", 128),
    (1, 96, 3, 16, 16, "float32", 32),
    (2, 100, 4, 32, 128, "float32", 100),
    # bf16 on the tensor cores: every P and N split and ragged edge
    (2, 128, 4, 16, 16, "bfloat16", 64),
    (1, 100, 4, 32, 128, "bfloat16", 100),
    (2, 1, 64, 64, 64, "bfloat16", 1),
    (2, 65, 64, 64, 64, "bfloat16", 65),
])
def test_ssd_kernel_vs_plain(cuda_device, B, S, H, P, N, dtype, chunk):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, dtype, B, S, H, P, N)
    before = ssdk.launches
    got = ssdk.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssdk.launches == before + 1
    want = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert _rel(got, want) < SCAN_REL[dtype]


@pytest.mark.parametrize("B,S,H,P,N,dtype", [
    (4, 512, 64, 64, 64, "bfloat16"),   # zamba2-1.2b's prefill shape
    (2, 65, 4, 64, 64, "bfloat16"),
    (2, 50, 4, 16, 32, "float32"),
])
def test_ssd_kernel_strong_decays(cuda_device, B, S, H, P, N, dtype):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, dtype, B, S, H, P, N,
                                   strong=True)
    got = ssdk.ssd_scan(x, dt, A, Bm, Cm, chunk=S)
    # the sequential oracle: the chunked form's long cumsums cancel in their
    # differences under such decays
    want = ref.ssd_scan_ref(x, dt, A, Bm, Cm)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert _rel(got, want) < SCAN_REL[dtype]


def test_scan_kernels_refuse_what_they_cannot_take(cuda_device):
    r, k, v, w, u = _wkv_inputs(cuda_device, "float32", 1, 8, 2, 48)
    with pytest.raises(ValueError, match="head dim"):
        wkvk.wkv6_scan(r, k, v, w, u, chunk=8)
    r, k, v, w, u = _wkv_inputs(cuda_device, "float32", 1, 8, 2, 64)
    with pytest.raises(ValueError, match="contiguous"):
        wkvk.wkv6_scan(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                       w, u, chunk=8)
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, "float32", 1, 8, 2, 48, 16)
    with pytest.raises(ValueError, match="head dim"):
        ssdk.ssd_scan(x, dt, A, Bm, Cm, chunk=8)
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, "float32", 1, 8, 2, 64, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ssdk.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                      Bm, Cm, chunk=8)
    # the bf16 kernel copies 16-byte chunks: a contiguous view at an odd
    # offset is refused by the launch, not read out of line
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, "bfloat16", 1, 8, 2, 64, 16)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device=cuda_device)[1:].view_as(x)
    shifted.copy_(x)
    with pytest.raises(RuntimeError, match="misaligned"):
        ssdk.ssd_scan(shifted, dt, A, Bm, Cm, chunk=8)


@pytest.mark.parametrize("arch,n_repeat", [("rwkv6-3b", 2), ("zamba2-1.2b", 1)])
@torch.inference_mode()
def test_serve_scan_models_launch_kernels_and_match_plain(cuda_device, arch,
                                                          n_repeat):
    """Full width, depth cut to n_repeat superblocks: every prefill scan
    and shared attention launches its kernel once, decode launches none."""
    cfg = registry.get_config(arch)
    cfg = cfg.replace(n_repeat=n_repeat, n_layers=len(cfg.prologue)
                      + n_repeat * len(cfg.superblock))
    params = lm.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                            cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(1))
    eng = ServeEngine(cfg, params, max_len=128)
    mods = (fak, wkvk, ssdk)
    before = [m.launches for m in mods]
    out = eng.generate(toks, 4)
    assert out.shape == (2, 4)
    kinds = [spec.kind for spec in cfg.plan]
    want = [kinds.count("shared_attn"), kinds.count("rwkv6"), kinds.count("mamba2")]
    assert [m.launches - b for m, b in zip(mods, before)] == want
    lk, _ = eng.prefill_fn(params, toks)
    # the kernels' plain versions: for rwkv6 the chunked WKV algorithm
    plain = ServeEngine(cfg.replace(use_pallas="never", wkv_impl="chunked"),
                        params, max_len=128)
    lp, _ = plain.prefill_fn(params, toks)
    lk, lp = lk.float(), lp.float()
    assert torch.isfinite(lk).all()
    assert float((lk - lp).abs().max() / lp.abs().max()) < 5e-2
