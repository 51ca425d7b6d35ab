"""Tests of the port that need the card: each CUDA kernel (flash attention
forward and backward, the WKV6 and SSD scans) against its plain version, the
serving and training paths launching them, and the ensemble executor's CUDA
graphs against its CPU path.  They carry
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
from repro_torch.serve.engine import ServeEngine, extra_shapes

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
    # D 192: MLA's prefill (qk_nope 128 + qk_rope 64), and its edges
    (4, 512, 512, 16, 16, 192, "bfloat16", True, None, None, 0),
    (2, 300, 300, 4, 2, 192, "bfloat16", True, 64, 30.0, 0),
    (1, 45, 83, 4, 2, 192, "bfloat16", False, None, None, 0),
    (2, 1, 101, 4, 4, 192, "bfloat16", True, None, None, 100),
    (2, 77, 130, 4, 2, 192, "float32", False, None, None, 0),
    (1, 100, 100, 4, 4, 192, "float32", True, 40, 20.0, 0),
    # whisper-tiny: the non-causal encoder, cross-attention to 1500 frames
    # at a prompt and at decode (S = 1: one valid row of the 64-row tile,
    # a ragged last key tile 1500 = 23 x 64 + 28)
    (4, 1500, 1500, 6, 6, 64, "bfloat16", False, None, None, 0),
    (4, 400, 1500, 6, 6, 64, "bfloat16", False, None, None, 0),
    (4, 1, 1500, 6, 6, 64, "bfloat16", False, None, None, 0),
    (4, 1, 1500, 6, 6, 64, "float32", False, None, None, 0),
    # llama-3.2-vision-11b: GQA 32:8 self-attention, and cross-attention
    # to 1600 image tokens at a prompt and at decode
    (4, 512, 512, 32, 8, 128, "bfloat16", True, None, None, 0),
    (4, 512, 1600, 32, 8, 128, "bfloat16", False, None, None, 0),
    (4, 1, 1600, 32, 8, 128, "bfloat16", False, None, None, 0),
    # starcoder2-15b: GQA 48:4
    (4, 512, 512, 48, 4, 128, "bfloat16", True, None, None, 0),
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


# ---------------------------------------------------------------------------
# the ensemble executor: one CUDA graph a bucket
# ---------------------------------------------------------------------------

def _bundle_rel(got, want):
    """max |got - want| / max |want| over each row; NaNs must coincide."""
    g = np.asarray(got, np.float64).reshape(len(got), -1)
    w = np.asarray(want, np.float64).reshape(len(want), -1)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    num = np.nanmax(np.abs(g - w), 1, initial=0.0)
    den = np.nanmax(np.abs(w), 1, initial=0.0)
    return float(np.where(num == 0, 0.0,
                          num / np.where(den == 0, 1e-300, den)).max())


@pytest.mark.parametrize("sim_name", ["jag", "seir"])
def test_graph_executor_matches_cpu_path(cuda_device, sim_name):
    """Two buckets (a ragged 37 -> 64 and a full 256): the card's replays
    give the CPU path's outputs at row-rel 1e-4 (SEIR: 1e-3, its float32
    cancellation in 1 - exp(-force)), NaNs and ``failed`` equal; a second
    call of a bucket captures nothing new.  One card (``mesh=None``): on a
    host with several, ``test_split_over_every_card_matches_one`` holds
    the split."""
    from repro_torch.core import ensemble as E
    from repro_torch.sim import jag_simulate, seir_simulate
    sim, d, tol = {"jag": (jag_simulate, 5, 1e-4),
                   "seir": (seir_simulate, 6, 1e-3)}[sim_name]
    rng = np.random.default_rng(3)
    gpu = E.EnsembleExecutor(sim, device=cuda_device, mesh=None)
    cpu = E.EnsembleExecutor(sim, device="cpu")
    for lo, n in ((5, 37), (100, 256)):
        block = rng.random((n, d)).astype(np.float32)
        if sim_name == "jag":
            block[0] = [0.999, 0.001, 0.5, 0.5, 0.5]
        before = E.trace_count()
        got = gpu.run_bundle(lo, lo + n, block)
        assert E.trace_count() - before == 1
        again = gpu.run_bundle(lo, lo + n, block)
        assert E.trace_count() - before == 1
        want = cpu.run_bundle(lo, lo + n, block)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert _bundle_rel(got[k], want[k]) <= tol, k
            np.testing.assert_array_equal(again[k], got[k])
        if "failed" in want:
            np.testing.assert_array_equal(got["failed"], want["failed"])
            assert got["failed"][0] == 1.0


def _exact_sim(u, draws):
    """An IEEE-exact simulator (add/mul/div/sqrt and counter-based uniform
    bits only): one device's result is every device's, bit for bit."""
    s = u * 2.0 + 0.25
    return {"v": s / (1.0 + u) + draws["noise"] * 0.001, "w": torch.sqrt(s)}


def _exact_draws(seeds, device=None):
    from repro_torch.sim import rng as R
    return {"noise": R.uniform(seeds, 0, 5)}


_exact_sim.draws_fn = _exact_draws


def _eager(sim, batch, lo, dev):
    x = torch.from_numpy(batch).to(dev)
    seeds = torch.arange(lo, lo + len(batch), dtype=torch.int64, device=dev)
    return {k: v.cpu().numpy() for k, v in sim(x, sim.draws_fn(seeds, dev))
            .items()}


def _program_check(dev, current):
    """A bucket program built and replayed on ``dev`` while ``current`` is
    the current device: the graph holds the work (no empty-graph warning),
    and each replay gives the eager result of its own inputs, not the
    capture's."""
    import warnings
    from repro_torch.core import ensemble as E
    rng = np.random.default_rng(7)
    with torch.cuda.device(current), warnings.catch_warnings():
        warnings.simplefilter("error")
        prog = E._Program(_exact_sim, _exact_draws, 16, 5, dev)
        for lo in (3, 40):
            batch = rng.random((16, 5)).astype(np.float32)
            got = {k: v.cpu().numpy()
                   for k, v in prog(_exact_sim, batch, lo, 16).items()}
            want = _eager(_exact_sim, batch, lo, dev)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


def test_graph_program_replays_its_own_inputs(cuda_device):
    _program_check(torch.device("cuda", 0), 0)


def test_graph_program_on_another_card_than_the_current(cuda_device):
    """A program for the last card, built while card 0 is current (the
    default capture stream lives on card 0)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards")
    _program_check(torch.device("cuda", 0), 0)  # card 0 captures first
    _program_check(torch.device("cuda", n - 1), 0)


@pytest.mark.parametrize("sim_name", ["exact", "jag"])
def test_split_over_every_card_matches_one(cuda_device, sim_name):
    """``mesh="auto"`` on a host with several cards splits every dividing
    bucket over all of them: bundles of [32, 32, 16, 5] rows equal one
    card's bit for bit for the exact simulator, JAG within row-rel 1e-3."""
    from repro_torch.core import ensemble as E
    from repro_torch.sim import jag_simulate
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards")
    sim = {"exact": _exact_sim, "jag": jag_simulate}[sim_name]
    split = E.EnsembleExecutor(sim, device=cuda_device, share_cache=False)
    one = E.EnsembleExecutor(sim, device=cuda_device, mesh=None,
                             share_cache=False)
    assert split.mesh == E.device_mesh() and split.stats["devices"] == n
    lo = 0
    for size in (32, 32, 16, 5):
        blk = np.random.default_rng(size + lo).random((size, 5)) \
            .astype(np.float32)
        got, want = (ex.run_bundle(lo, lo + size, blk) for ex in (split, one))
        for k in want:
            if sim_name == "exact":
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert _bundle_rel(got[k], want[k]) <= 1e-3, k
        lo += size
    assert split.stats["mesh_launches"] >= 1


def test_deferred_writes_under_four_threads_match_blocking(cuda_device,
                                                           tmp_path):
    """Four threads launch bundles of one bucket and write them later: each
    file equals the blocking path's, so no replay overwrote an output that
    a pending write had yet to copy."""
    import threading
    from repro_torch.core import ensemble as E
    from repro_torch.core.bundler import Bundler
    from repro_torch.sim import jag_simulate
    samples = np.random.default_rng(4).random((32 * 24, 5)).astype(np.float32)
    spans = [(lo, lo + 24) for lo in range(0, len(samples), 24)]
    blocking = Bundler(str(tmp_path / "block"))
    ex = E.EnsembleExecutor(jag_simulate, blocking, device=cuda_device)
    for lo, hi in spans:
        ex.run_bundle(lo, hi, samples[lo:hi])
    deferred = Bundler(str(tmp_path / "defer"))
    exd = E.EnsembleExecutor(jag_simulate, deferred, device=cuda_device)
    pending, lock, errors = [], threading.Lock(), []

    def launch(part):
        try:
            for lo, hi in part:
                fin = exd.run_bundle(lo, hi, samples[lo:hi], defer_write=True)
                with lock:
                    pending.append(fin)
        except Exception as e:  # surfaced below
            errors.append(e)
    threads = [threading.Thread(target=launch, args=(spans[i::4],))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for fin in pending:   # every write after every launch
        fin()
    a, b = blocking.load_all(), deferred.load_all()
    assert list(b["_sample_ids"]) == list(range(len(samples)))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_surrogate_on_the_card_matches_the_cpu(cuda_device):
    """One seed, one init: predictions after 400 steps at 1e-3 of the
    largest magnitude."""
    from repro_torch.core import active as A
    rng = np.random.default_rng(5)
    X = rng.random((300, 5)).astype(np.float32)
    y = (X[:, 0] ** 2 - 0.5 * X[:, 1] + 0.1 * np.sin(6 * X[:, 2])).astype(
        np.float32)
    gpu = A.train_surrogate(X, y, steps=400, device=cuda_device)
    cpu = A.train_surrogate(X, y, steps=400, device="cpu")
    grid = rng.random((128, 5)).astype(np.float32)
    mg, sg = gpu.predict(grid)
    mc, sc = cpu.predict(grid)
    scale = np.abs(mc).max()
    assert np.abs(mg - mc).max() <= 1e-3 * scale
    assert np.abs(sg - sc).max() <= 1e-3 * scale


# ---------------------------------------------------------------------------
# gradients: flash has its backward kernel, the scans refuse grad
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_grad(cuda_device):
    """Under grad with an input that requires it, flash attention returns
    an output with a ``grad_fn`` whose backward is one launch of the
    backward kernel; WKV6 and SSD still raise ("no backward") instead of
    returning an output without ``grad_fn``.  Under no_grad, or with no
    input requiring grad, each launches its forward and nothing else."""
    q, k, v = _qkv(cuda_device, "bfloat16", 1, 64, 64, 4, 4, 64)
    r, kw, vw, w, u = _wkv_inputs(cuda_device, "bfloat16", 1, 32, 4, 64)
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, "bfloat16", 1, 32, 4, 64, 64)
    for t in (q, k, v):
        t.requires_grad_(True)
        before, bwd = fak.launches, fak.bwd_launches
        out = fak.flash_attention(q, k, v)
        assert out.grad_fn is not None and fak.launches == before + 1
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        assert fak.bwd_launches == bwd + 1 and fak.launches == before + 1
        assert t.grad is not None and t.grad.dtype == t.dtype
        assert torch.isfinite(t.grad.float()).all()
        t.grad = None
        with torch.no_grad():
            fak.flash_attention(q, k, v)
        with torch.inference_mode():
            fak.flash_attention(q, k, v)
        assert fak.launches == before + 3 and fak.bwd_launches == bwd + 1
        t.requires_grad_(False)
    assert fak.flash_attention(q, k, v).grad_fn is None
    calls = [(wkvk, lambda: wkvk.wkv6_scan(r, kw, vw, w, u, chunk=32),
              (r, kw, vw, w, u)),
             (ssdk, lambda: ssdk.ssd_scan(x, dt, A, Bm, Cm, chunk=32),
              (x, dt, A, Bm, Cm))]
    for mod, call, inputs in calls:
        for t in inputs:
            t.requires_grad_(True)
            before = mod.launches
            with pytest.raises(RuntimeError, match="no backward"):
                call()
            assert mod.launches == before
            with torch.no_grad():
                call()
            with torch.inference_mode():
                call()
            assert mod.launches == before + 2
            t.requires_grad_(False)
        out = call()
        assert out.grad_fn is None


def test_d192_under_grad_raises(cuda_device):
    """The forward takes D 192 (MLA's prefill); the backward kernel does
    not, so a call under grad raises before any launch, as do the lse and
    backward entries, and nothing falls back."""
    for dtype in ("bfloat16", "float32"):
        q, k, v = _qkv(cuda_device, dtype, 1, 64, 64, 4, 4, 192)
        before, bwd = fak.launches, fak.bwd_launches
        q.requires_grad_(True)
        with pytest.raises(ValueError, match="no backward kernel"):
            fak.flash_attention(q, k, v)
        q.requires_grad_(False)
        with pytest.raises(ValueError, match="no backward kernel"):
            fak.flash_attention_lse(q, k, v)
        with pytest.raises(ValueError, match="no backward kernel"):
            fak.flash_attention_bwd(q, k, v, q, torch.zeros(
                1, 4, 64, device=cuda_device), q)
        assert (fak.launches, fak.bwd_launches) == (before, bwd)
        with torch.no_grad():
            q.requires_grad_(True)
            fak.flash_attention(q, k, v)
        assert fak.launches == before + 1


def _mla_moe_cfg(**over):
    """deepseek-v2-lite's reduced config at the full MLA head widths (nope
    128 + rope 64 = 192, a kernel dim; the reduced 48 is not)."""
    cfg = registry.reduced_config("deepseek-v2-lite-16b")
    return cfg.replace(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
                       kv_lora_rank=64, **over)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("absorb", [True, False])
@torch.inference_mode()
def test_mla_layer_on_the_card_matches_the_cpu(cuda_device, dtype, absorb):
    from repro_torch.models import layers as L
    cfg = _mla_moe_cfg(compute_dtype=dtype, mla_absorb=absorb)
    spec = cfg.superblock[0]
    mod = L.init_mla(torch.Generator().manual_seed(0), cfg, "cpu")
    card = L.init_mla(torch.Generator(device=cuda_device).manual_seed(1), cfg,
                      cuda_device)
    card.load_state_dict(mod.state_dict())
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 70, cfg.d_model),
                                             dtype=np.float32)).to(TDT[dtype])
    outs = {}
    for dev, m in (("cpu", mod), (cuda_device, card)):
        cache = L.init_mla_cache(cfg, 2, 80, TDT[dtype], dev)
        before = fak.launches
        pre, _ = L.mla_attention(m, x[:, :69].to(dev), cfg, spec,
                                 positions=torch.arange(69, device=dev),
                                 cache=cache, cache_pos=0)
        dec, _ = L.mla_attention(m, x[:, 69:].to(dev), cfg, spec,
                                 positions=torch.tensor([69], device=dev),
                                 cache=cache, cache_pos=69)
        assert fak.launches - before == (1 if dev != "cpu" else 0)
        outs[dev if dev == "cpu" else "cuda"] = (pre.cpu(), dec.cpu(),
                                                 cache["latent"].cpu())
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert _rel(got, want) < SCAN_REL[dtype] * 5


@pytest.mark.parametrize("impl", ["gshard", "sort"])
@torch.inference_mode()
def test_moe_layer_on_the_card_matches_the_cpu(cuda_device, impl):
    """float32: same routes on both devices, outputs and aux losses agree."""
    from repro_torch.models import moe as MOE
    cfg = _mla_moe_cfg(compute_dtype="float32", moe_impl=impl,
                       capacity_factor=0.5)
    mod = MOE.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    card = MOE.init_moe(torch.Generator(device=cuda_device).manual_seed(1), cfg,
                        cuda_device)
    card.load_state_dict(mod.state_dict())
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 50, cfg.d_model), dtype=np.float32))
    want, want_aux = MOE.moe_layer(mod, x, cfg)
    got, got_aux = MOE.moe_layer(card, x.to(cuda_device), cfg)
    assert _rel(got.cpu(), want) < 1e-4
    for key in want_aux:
        assert _rel(got_aux[key].cpu(), want_aux[key]) < 1e-4


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma2-27b",
                                  "deepseek-v2-lite-16b", "starcoder2-15b"])
@torch.inference_mode()
def test_serve_variant_models_launch_per_attention_layer(cuda_device, arch):
    """Full width, depth cut to 2 superblocks: one flash forward per
    attention or MLA layer a prefill, none at decode; float32-compute
    logits match the plain run's."""
    cfg = registry.get_config(arch)
    cfg = cfg.replace(n_repeat=2, n_layers=len(cfg.prologue)
                      + 2 * len(cfg.superblock), compute_dtype="float32")
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
    assert _rel(lk, lp) < 1e-3


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-11b"])
@torch.inference_mode()
def test_serve_encdec_models_launch_per_layer_and_step(cuda_device, arch):
    """Reduced configs in float32 compute, random extras, every xgate 1.0:
    a prefill launches the flash forward once per encoder layer, per
    self-attention and per cross-attention; a decode step once per
    cross-attention layer (self-attention decode is plain).  Prefill and
    first decode-step logits match the plain run's."""
    cfg = registry.reduced_config(arch).replace(compute_dtype="float32")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = lm.init_params(cfg, gen, cuda_device)
    for p, spec in zip(params.layers, cfg.plan):
        if spec.kind == "xattn":
            p.xgate.fill_(1.0)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), device=cuda_device,
                         generator=gen)
    ex = {k: torch.randn(shape, generator=gen, device=cuda_device)
          for k, shape in extra_shapes(cfg, 2).items()}
    n_cross = sum(s.kind in ("xattn", "dec") for s in cfg.plan)
    n_self = sum(s.kind in ("attn", "dec") for s in cfg.plan)
    assert n_cross == 2
    logits, tok = {}, None
    for name, c in (("kernel", cfg), ("plain", cfg.replace(use_pallas="never"))):
        eng = ServeEngine(c, params, max_len=32)
        before = fak.launches
        lk, caches = eng.prefill_fn(params, toks, *ex.values())
        prefill_launches = fak.launches - before
        if tok is None:  # both runs decode the kernel run's first token
            tok = lk[:, -1].argmax(-1)[:, None]
        before = fak.launches
        ld, _ = eng.decode_fn(params, tok, caches)
        decode_launches = fak.launches - before
        if name == "kernel":
            assert prefill_launches == cfg.n_enc_layers + n_self + n_cross
            assert decode_launches == n_cross
            out = eng.generate(toks, 4, extra=ex)
            assert out.shape == (2, 4)
        else:
            assert prefill_launches == decode_launches == 0
        logits[name] = (lk, ld)
    for got, want in zip(logits["kernel"], logits["plain"]):
        assert _rel(got, want) < 1e-3


# max |kernel - plain| / max |plain|: float32 sums in another order; the
# bf16 kernel rounds P and dS to bf16 as operands and its outputs once, and
# against ref.flash_attention_bwd_tc_ref, the mirror of those rounding
# points, only the order of its fp32 sums is left
BWD_REL = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_TC_REL = 1e-2


@pytest.mark.parametrize("B,S,T,H,KV,D,dtype,causal,window,softcap", [
    (8, 128, 128, 4, 4, 64, "bfloat16", True, None, None),  # jag training
    (8, 8, 8, 4, 4, 64, "bfloat16", True, None, None),      # jag on bundles
    (2, 200, 200, 8, 2, 128, "bfloat16", True, None, None),
    (2, 300, 300, 4, 2, 32, "bfloat16", True, 64, 30.0),
    (1, 130, 130, 2, 1, 16, "bfloat16", True, None, None),
    (1, 33, 70, 4, 1, 64, "bfloat16", False, None, None),
    (2, 100, 100, 4, 2, 64, "bfloat16", False, 24, None),
    (1, 130, 130, 2, 1, 16, "float32", True, None, None),
    (1, 33, 70, 4, 1, 64, "float32", False, None, None),
    (2, 100, 100, 4, 2, 64, "float32", True, 16, 30.0),
    # the encoder archs' training shapes: whisper's 1500-frame encoder (23
    # full 64-row tiles and 28 rows) and decoder cross-attention, and
    # llama-vision's GQA 32:8 cross-attention over 1600 image tokens
    (1, 1500, 1500, 6, 6, 64, "bfloat16", False, None, None),
    (1, 128, 1500, 6, 6, 64, "bfloat16", False, None, None),
    (1, 128, 1600, 32, 8, 128, "bfloat16", False, None, None),
])
def test_backward_kernel_vs_plain(cuda_device, B, S, T, H, KV, D, dtype,
                                  causal, window, softcap):
    """dq, dk, dv of the backward kernel against ref.flash_attention_bwd_ref
    (and in bf16 against ref.flash_attention_bwd_tc_ref) on the same q, k,
    v, o, dO and log-sum-exp (the forward kernel's, which is held to
    flash_attention_lse_ref's)."""
    q, k, v = _qkv(cuda_device, dtype, B, S, T, H, KV, D)
    rng = np.random.default_rng(9)
    do = torch.from_numpy(rng.standard_normal((B, S, H, D), dtype=np.float32)
                          ).to(cuda_device, TDT[dtype])
    kw = dict(causal=causal, window=window, softcap_val=softcap)
    out, lse = fak.flash_attention_lse(q, k, v, **kw)
    _, lse_plain = ref.flash_attention_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(lse, lse_plain, atol=1e-3, rtol=1e-5)
    before = fak.bwd_launches
    got = fak.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert fak.bwd_launches == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == TDT[dtype]
        assert _rel(a, b) < BWD_REL[dtype], name
    if dtype == "bfloat16":
        mirror = ref.flash_attention_bwd_tc_ref(q, k, v, out, do, lse, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), got, mirror):
            assert _rel(a, b) < BWD_TC_REL, name


def test_backward_takes_misaligned_bf16_views(cuda_device):
    """The bf16 kernels copy 16-byte chunks; an input that is a contiguous
    view at an odd offset is copied by the wrapper, not refused, and the
    gradients equal the aligned call's."""
    q, k, v = _qkv(cuda_device, "bfloat16", 2, 40, 40, 4, 2, 64)
    do = _qkv(cuda_device, "bfloat16", 2, 40, 40, 4, 2, 64, seed=3)[0]
    out, lse = fak.flash_attention_lse(q, k, v)

    def shifted(t):
        view = torch.empty(t.numel() + 1, dtype=t.dtype,
                           device=t.device)[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        return view
    want = fak.flash_attention_bwd(q, k, v, out, lse, do)
    got = fak.flash_attention_bwd(*map(shifted, (q, k, v, out)), lse,
                                  shifted(do))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_backward_kernel_refuses_what_it_cannot_take(cuda_device):
    q, k, v = _qkv(cuda_device, "float32", 1, 8, 8, 2, 2, 64)
    q.requires_grad_(True)
    with pytest.raises(ValueError, match="q_pos0"):
        fak.flash_attention(q, k, v, q_pos0=4)
    with pytest.raises(ValueError, match="no key"):
        fak.flash_attention(q, k[:, :4].contiguous(), v[:, :4].contiguous(),
                            causal=False, window=2)


def test_training_steps_on_the_card_match_the_cpu(cuda_device, tmp_path):
    """Three AdamW steps of reduced jag-surrogate in float32 compute from
    one seed and one batch stream: the card (flash forward and backward
    kernels, remat="full") against the CPU (plain versions).  Losses and
    grad norms at rel 1e-4, AdamW's moments after the steps at rel 1e-3
    (not the parameters: a near-zero gradient's sign may flip between the
    two, and AdamW moves that parameter by lr either way); the flash counts
    are 2 forwards (one a recompute) and 1 backward per layer and step."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.trainstep import init_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = registry.reduced_config("jag-surrogate").replace(
        compute_dtype="float32")
    runs = {}
    for dev in ("cpu", cuda_device):
        state = init_state(torch.Generator().manual_seed(0), cfg, device=dev)
        step = make_train_step(cfg, make_optimizer("adamw", lr=1e-3))
        data = SyntheticTokens(4, 64, cfg.vocab_size)
        before = (fak.launches, fak.bwd_launches)
        metrics = []
        for i in range(3):
            state, m = step(state, data.batch_at(i))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[str(dev)] = (metrics, state, (fak.launches - before[0],
                                           fak.bwd_launches - before[1]))
    (mc, sc, lc), (mg, sg, lg) = runs["cpu"], runs[str(cuda_device)]
    assert lc == (0, 0)
    assert lg == (2 * cfg.n_layers * 3, cfg.n_layers * 3)
    np.testing.assert_allclose(np.array(mg), np.array(mc), rtol=1e-4)
    for k in ("m", "v"):
        for name, a in sg.opt[k].items():
            assert _rel(a.cpu(), sc.opt[k][name]) < 1e-3, (k, name)


def test_whisper_train_step_launches_per_layer(cuda_device, tmp_path):
    """One launch.train step of reduced whisper-tiny on the card: per
    microbatch, each encoder layer one non-causal flash forward and one
    backward (the encoder runs outside remat), each decoder layer two
    attentions (self and cross), each forward twice under remat="full"
    and backward once."""
    from repro_torch.launch import train as launch_train
    cfg = registry.reduced_config("whisper-tiny")
    assert cfg.remat == "full" and not cfg.prologue
    summary, tr = launch_train.main(
        ["--arch", "whisper-tiny", "--reduced", "--steps", "1", "--batch",
         "2", "--seq", "16", "--workdir", str(tmp_path)])
    n_mb = max(1, cfg.microbatch)
    assert summary["flash_launches"] == n_mb * (cfg.n_enc_layers
                                                + 2 * 2 * cfg.n_layers)
    assert summary["flash_bwd_launches"] == n_mb * (cfg.n_enc_layers
                                                    + 2 * cfg.n_layers)
    assert summary["wkv6_launches"] == summary["ssd_launches"] == 0
    assert np.isfinite(summary["final_loss"])


@pytest.mark.parametrize("remat,fwd_per_layer", [("none", 1), ("full", 2),
                                                  ("dots", 2)])
def test_remat_modes_on_the_card(cuda_device, remat, fwd_per_layer):
    """Each remat mode gives the CPU's loss and gradients in float32
    (rel 1e-4) through the flash kernels; ``full`` and ``dots`` run the
    forward kernel again in the backward's recompute (``dots`` keeps only
    the x @ W products), ``none`` does not; one backward a layer."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.train.trainstep import to_device
    cfg = registry.reduced_config("jag-surrogate").replace(
        compute_dtype="float32", remat=remat)
    batch = SyntheticTokens(2, 64, cfg.vocab_size).batch_at(0)
    grads = {}
    for dev in ("cpu", cuda_device):
        model = lm.init_params(cfg, torch.Generator().manual_seed(0),
                               "cpu").to(dev)
        before = (fak.launches, fak.bwd_launches)
        loss, _ = lm.loss_fn(model, to_device(batch, dev), cfg)
        g = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        grads[str(dev)] = (float(loss.detach()), [t.cpu() for t in g],
                           (fak.launches - before[0],
                            fak.bwd_launches - before[1]))
    (lc, gc, nc), (lg, gg, ng) = grads["cpu"], grads[str(cuda_device)]
    assert nc == (0, 0)
    assert ng == (fwd_per_layer * cfg.n_layers, cfg.n_layers)
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for a, b in zip(gg, gc):
        assert _rel(a, b) < 1e-4


# ---------------------------------------------------------------------------
# the Merlin path across threads and processes on the card
# ---------------------------------------------------------------------------

def test_predicts_run_through_a_refresh_capture(cuda_device, tmp_path):
    """A refresh retrains and captures its Adam step on one thread while
    four threads keep predicting on the same card: every prediction equals
    the old model's or the new one's, some of them ran during the
    refresh, and the new model predicts what a surrogate trained on the
    same rows without concurrent predicts does."""
    import threading
    from repro_torch.core import active as A
    from repro_torch.core.bundler import Bundler
    rng = np.random.default_rng(7)
    X = rng.random((512, 5)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + X[:, 1] ** 2).astype(np.float32)
    root = str(tmp_path / "study")
    Bundler(root).write_bundle(0, 256, {"inputs": X[:256], "yield": y[:256]})
    snap = A.SurrogateSnapshot(root, device=cuda_device)
    grid = rng.random((32, 5)).astype(np.float32)
    old = snap.predict(grid)
    Bundler(root).write_bundle(256, 512, {"inputs": X[256:],
                                          "yield": y[256:]})
    refreshing, stop = threading.Event(), threading.Event()
    seen, errors = [], []

    def client():
        try:
            while not stop.is_set():
                during = refreshing.is_set()
                seen.append((snap.predict(grid), during))
        except Exception as e:  # surfaced below
            errors.append(e)
    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        refreshing.set()
        assert snap.refresh()
        refreshing.clear()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors
    assert snap.version == 2 and snap.rows == 512
    new = snap.predict(grid)
    assert sum(during for _, during in seen) >= 1
    for (mu, sd), _ in seen:
        assert any(np.array_equal(mu, m) and np.array_equal(sd, s)
                   for m, s in (old, new))
    alone = A.train_surrogate(X, y, device=cuda_device).predict(grid)
    scale = np.abs(alone[0]).max()
    assert np.abs(new[0] - alone[0]).max() <= 1e-6 * scale
    assert np.abs(new[1] - alone[1]).max() <= 1e-6 * scale


def test_cascade_on_the_card_matches_the_cpu(cuda_device):
    """The COVID cascade as the example shapes it, on the card and on the
    CPU with the same observations: calibration bundles at row-rel 3.4e-4
    (SEIR's float32 bar), each metro's posterior RMSE within rel 1e-3, and
    on the card NPIs lower the median peak."""
    from repro_torch.launch import covid_calibration as cc
    obs = cc.synth_observations(device="cpu")
    card, calib = cc.run_cascade(cuda_device, observed=obs)
    cpu, calib_cpu = cc.run_cascade("cpu", observed=obs)
    for m in cc.METROS:
        a, b = calib[m], calib_cpu[m]
        oa, ob = np.argsort(a["_sample_ids"]), np.argsort(b["_sample_ids"])
        assert list(a["_sample_ids"][oa]) == list(range(cc.N_CALIB))
        for key in b:
            assert _bundle_rel(a[key][oa], b[key][ob]) <= 3.4e-4, (m, key)
        rmse, rmse_cpu = card[m]["posterior_rmse"], cpu[m]["posterior_rmse"]
        assert abs(rmse - rmse_cpu) <= 1e-3 * abs(rmse_cpu)
        assert card[m]["strong_npi"]["peak_median"] <= \
            card[m]["baseline"]["peak_median"] + 1e-6


def test_quickstart_two_process_on_the_card(cuda_device):
    """``quickstart --two-process``: the study over one broker-serve process
    on tcp:// bundles 512 of 512 on the card."""
    from repro_torch.launch import quickstart
    summary, data, _ = quickstart.run_study(cuda_device, samples=512,
                                            broker_mode="tcp")
    assert summary["broker"] == "NetBroker"
    assert sorted(int(i) for i in data["_sample_ids"]) == list(range(512))
    assert summary["r2"] >= 0.9
