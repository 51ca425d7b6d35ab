"""Tests of the port that need the card: each CUDA kernel (flash attention,
the WKV6 and SSD scans) against its plain version, the serving paths
launching them, and the ensemble executor's CUDA graphs against its CPU
path.  They carry
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
    call of a bucket captures nothing new."""
    from repro_torch.core import ensemble as E
    from repro_torch.sim import jag_simulate, seir_simulate
    sim, d, tol = {"jag": (jag_simulate, 5, 1e-4),
                   "seir": (seir_simulate, 6, 1e-3)}[sim_name]
    rng = np.random.default_rng(3)
    gpu = E.EnsembleExecutor(sim, device=cuda_device)
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
# the kernels have no backward: they refuse an input that requires grad
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_grad(cuda_device):
    """Under grad with an input that requires it, each wrapper raises
    instead of returning an output without ``grad_fn``; under no_grad, or
    with no input requiring grad, it launches."""
    q, k, v = _qkv(cuda_device, "bfloat16", 1, 64, 64, 4, 4, 64)
    r, kw, vw, w, u = _wkv_inputs(cuda_device, "bfloat16", 1, 32, 4, 64)
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, "bfloat16", 1, 32, 4, 64, 64)
    calls = [(fak, lambda: fak.flash_attention(q, k, v), (q, k, v)),
             (wkvk, lambda: wkvk.wkv6_scan(r, kw, vw, w, u, chunk=32),
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
