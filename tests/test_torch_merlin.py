"""The port's Merlin loop on the CPU: the ensemble executor, the copied
runtime driving it, and the deep-ensemble surrogate, against the JAX
reference where the two compute the same function.

Tolerances (each stated where it is used):
* bundles of the port's executor against the reference's executor on the
  same rows and the same draws: ``max |port - ref| / max |ref|`` over each
  row at 1e-4, NaNs at the same places, identical bundle files;
* bucketed against unbucketed, coalesced against per-task, deferred
  against blocking: 1e-6 (the same function on the same rows; batches of
  other sizes take other SIMD paths, so near-zero image pixels differ in
  the last places and the row norm above is used where batches differ);
* surrogate parameters after 1 and 10 Adam steps from one init:
  ``max |port - ref| / max |ref|`` per leaf at 1e-4; predictions (mean and
  std) after 300 steps at 1e-3 of the largest magnitude.
"""
import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import active as A_ref
from repro.core import ensemble as E_ref
from repro.core.bundler import Bundler as Bundler_ref
from repro.sim import jag_simulate as jag_ref
from repro_torch import convert
from repro_torch.core import active as A
from repro_torch.core import ensemble as E
from repro_torch.core.bundler import Bundler
from repro_torch.core.hierarchy import HierarchyCfg
from repro_torch.core.queue import FileBroker, InMemoryBroker, new_task
from repro_torch.core.runtime import MerlinRuntime
from repro_torch.core.spec import Step, StudySpec
from repro_torch.core.worker import WorkerPool
from repro_torch.launch import icf_ensemble, quickstart
from repro_torch.sim import jag_simulate, null_simulate, seir_simulate
from repro_torch.sim.jag import IMG, N_VIEWS

CPU = "cpu"


def _toy_sim(u, draws):
    """Cheap batched simulator with one normal a row (a fresh function per
    test module => a fresh process-wide cache key)."""
    return {"v": u.sum(-1) + draws["z"][:, 0] * 1e-3, "inputs": u}


def _toy_draws(seeds, device=None):
    from repro_torch.sim import rng
    return {"z": rng.normal(seeds, 0, 1)}


_toy_sim.draws_fn = _toy_draws


def _row_rel(got, want):
    g = np.asarray(got, np.float64).reshape(len(got), -1)
    w = np.asarray(want, np.float64).reshape(len(want), -1)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    num = np.nanmax(np.abs(g - w), 1, initial=0.0)
    den = np.nanmax(np.abs(w), 1, initial=0.0)
    return float(np.where(num == 0, 0.0,
                          num / np.where(den == 0, 1e-300, den)).max())


# ---------------------------------------------------------------------------
# the executor's contract (the cases of tests/test_ensemble_perf.py:35-176)
# ---------------------------------------------------------------------------

def test_bucketed_compile_count_is_log_bounded():
    def sim(u, draws):
        return {"v": u * 2.0, "s": draws["z"][:, 0]}
    sim.draws_fn = _toy_draws

    ex = E.EnsembleExecutor(sim, device=CPU)
    rng = np.random.default_rng(0)
    sizes = [1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 16, 21, 27, 5, 3, 27]
    before = E.trace_count()
    lo = 0
    for s in sizes:
        out = ex.run_bundle(lo, lo + s, rng.random((s, 3)).astype(np.float32))
        assert out["v"].shape == (s, 3)  # padding sliced away
        assert isinstance(out["v"], np.ndarray)
        lo += s
    # 13 distinct ragged sizes, but programs bounded by the bucket schedule
    built = E.trace_count() - before
    assert built <= math.ceil(math.log2(max(sizes))) + 1
    assert built == ex.stats["compiles"] == len(
        {E.bucket_for(s) for s in sizes})
    assert ex.stats["samples"] == sum(sizes)
    assert ex.stats["launches"] == len(sizes)
    assert ex.stats["padded_samples"] == sum(E.bucket_for(s) - s
                                             for s in sizes)
    assert set(ex.stats) == {"bundles", "samples", "sim_time", "write_s",
                             "compiles", "launches", "padded_samples",
                             "mesh_launches", "devices"}


def test_shared_cache_across_executors():
    def sim(u, draws):
        return {"v": u + 1.0}

    rng = np.random.default_rng(0)
    E.EnsembleExecutor(sim, device=CPU).run_bundle(
        0, 8, rng.random((8, 2)).astype(np.float32))
    before = E.trace_count()
    # a fresh executor (new bundler, new iteration, new study) reuses the
    # process-wide program: nothing new built
    E.EnsembleExecutor(sim, device=CPU).run_bundle(
        8, 16, rng.random((8, 2)).astype(np.float32))
    assert E.trace_count() == before
    # an executor that opts out builds its own
    E.EnsembleExecutor(sim, device=CPU, share_cache=False).run_bundle(
        16, 24, rng.random((8, 2)).astype(np.float32))
    assert E.trace_count() == before + 1


def test_cache_lets_a_dead_simulator_go():
    def sim(u, draws):
        return {"v": u + 1.0}
    E.EnsembleExecutor(sim, device=CPU).run_bundle(
        0, 4, np.zeros((4, 2), np.float32))
    assert sim in E._SHARED
    n = len(E._SHARED)
    del sim
    import gc
    gc.collect()
    assert len(E._SHARED) == n - 1


def test_bucketed_results_match_unbucketed(tmp_path):
    rng = np.random.default_rng(3)
    block = rng.random((5, 4)).astype(np.float32)
    b1 = Bundler(str(tmp_path / "a"))
    b2 = Bundler(str(tmp_path / "b"))
    E.EnsembleExecutor(_toy_sim, b1, device=CPU).run_bundle(10, 15, block)
    E.EnsembleExecutor(_toy_sim, b2, bucketed=False, share_cache=False,
                       device=CPU).run_bundle(10, 15, block)
    d1, d2 = b1.load_all(), b2.load_all()
    assert set(d1) == set(d2)
    for k in d1:
        np.testing.assert_allclose(d1[k], d2[k], rtol=1e-6)


def test_pad_rows_repeat_the_last_row_and_seeds_run_on():
    """Seeds lo … lo+padded-1, pad rows repeating the last row: the rows
    of a padded bundle equal the same rows run alone."""
    rng = np.random.default_rng(4)
    block = rng.random((5, 3)).astype(np.float32)
    ex = E.EnsembleExecutor(_toy_sim, device=CPU)
    whole = ex.run_bundle(20, 25, block)
    one = ex.run_bundle(22, 23, block[2:3])
    np.testing.assert_array_equal(whole["v"][2:3], one["v"])
    np.testing.assert_array_equal(
        E.pad_rows(block, 8)[5:], np.repeat(block[-1:], 3, 0))


def test_block_false_returns_tensors_and_defer_needs_a_call(tmp_path):
    ex = E.EnsembleExecutor(_toy_sim, device=CPU)
    out = ex.run_bundle(0, 3, np.ones((3, 2), np.float32), block=False)
    assert isinstance(out["v"], torch.Tensor) and out["v"].shape == (3,)
    b = Bundler(str(tmp_path))
    exb = E.EnsembleExecutor(_toy_sim, b, device=CPU)
    pending = exb.run_bundle(0, 4, np.ones((4, 2), np.float32),
                             sub_ranges=[(0, 2), (2, 4)], defer_write=True)
    assert callable(pending) and b.load_all() == {}
    host = pending()
    assert host["v"].shape == (4,)
    assert list(b.load_all()["_sample_ids"]) == [0, 1, 2, 3]
    assert exb.stats["write_s"] > 0


def test_concurrent_bundles_lose_no_count():
    """8 threads share one executor with a tiny switch interval: every
    bundle is counted and every thread gets its own rows back."""
    import sys
    import threading
    ex = E.EnsembleExecutor(_toy_sim, device=CPU)
    rows = np.random.default_rng(2).random((8 * 40, 3)).astype(np.float32)
    errors = []

    def work(t):
        try:
            for i in range(40):
                lo = t * 40 + i
                out = ex.run_bundle(lo, lo + 1, rows[lo:lo + 1])
                np.testing.assert_array_equal(out["inputs"], rows[lo:lo + 1])
        except Exception as e:  # reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert ex.stats["samples"] == ex.stats["bundles"] == 320


def test_executor_refuses_what_it_does_not_do():
    with pytest.raises(TypeError, match="tuple of devices"):
        E.EnsembleExecutor(_toy_sim, device=CPU, mesh=object())
    assert E.EnsembleExecutor(_toy_sim, device=CPU).mesh is None
    assert E.EnsembleExecutor(_toy_sim, device=CPU, mesh=None).mesh is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            E.EnsembleExecutor(_toy_sim)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            A.train_surrogate(np.zeros((4, 2)), np.zeros(4), steps=1)
    with pytest.raises(ValueError, match="rows"):
        E.EnsembleExecutor(_toy_sim, device=CPU).run_bundle(
            0, 4, np.zeros((3, 2), np.float32))


def _jax_jag_draws(seeds, device=None):
    """The reference's own draws for these seeds (jag.py:94)."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds.numpy(), jnp.uint32))
    noise = jax.vmap(lambda k: jax.random.normal(k, (N_VIEWS, IMG, IMG)))(keys)
    return {"noise": torch.from_numpy(np.array(noise))}


def test_executor_bundles_match_the_reference_executor(tmp_path):
    """Same rows, same draws: the port's bundles equal the reference's at
    row-rel 1e-4 (NaNs equal, ``failed`` exactly), file for file."""
    block = np.random.default_rng(5).random((37, 5)).astype(np.float32)
    block[3] = [0.999, 0.001, 0.5, 0.5, 0.5]   # a failed implosion
    spans = [(10, 20), (20, 40), (40, 47)]
    br = Bundler_ref(str(tmp_path / "ref"))
    bp = Bundler(str(tmp_path / "port"))
    E_ref.EnsembleExecutor(jag_ref, br, mesh=None).run_bundle(
        10, 47, block, sub_ranges=spans)
    def jag_on_jax_draws(u, draws):
        return jag_simulate(u, draws)
    jag_on_jax_draws.draws_fn = _jax_jag_draws
    E.EnsembleExecutor(jag_on_jax_draws, bp, device=CPU).run_bundle(
        10, 47, block, sub_ranges=spans)
    dr, dp = br.load_all(), bp.load_all()
    assert set(dr) == set(dp)
    np.testing.assert_array_equal(dp["failed"], dr["failed"])
    assert dp["failed"][3] == 1.0
    for k in dr:
        assert _row_rel(dp[k], dr[k]) <= 1e-4, k
    files = [sorted(f for _, _, fs in os.walk(b.root) for f in fs)
             for b in (br, bp)]
    assert files[0] == files[1]


def _run_study(workspace, batch, samples, sim=_toy_sim, bundle=4,
               engine="auto", n_workers=1):
    rt = MerlinRuntime(workspace=workspace,
                       hierarchy=HierarchyCfg(max_fanout=8, bundle=bundle))
    bundler = Bundler(os.path.join(workspace, "res"))
    ex = E.EnsembleExecutor(sim, bundler, device=CPU)
    rt.register("sim", ex.step_fn())
    spec = StudySpec(name="co", steps=[Step(name="sim", fn="sim")])
    with WorkerPool(rt, n_workers=n_workers, batch=batch, engine=engine):
        sid = rt.run(spec, samples)
        assert rt.wait(sid, timeout=120)
    return rt, bundler, ex


def test_coalesced_execution_matches_per_task(tmp_path):
    samples = np.random.default_rng(7).random((24, 4)).astype(np.float32)
    rt1, b1, _ = _run_study(str(tmp_path / "seq"), 1, samples)     # per-task
    rt2, b2, _ = _run_study(str(tmp_path / "coal"), 16, samples)   # coalesced
    d1, d2 = b1.load_all(), b2.load_all()
    assert set(d1) == set(d2)
    for k in d1:
        np.testing.assert_allclose(d1[k], d2[k], rtol=1e-6,
                                   err_msg=f"key {k} diverged under coalescing")
    # on-disk layout preserved: one bundle file per original leaf task
    files1 = sorted(f for _, _, fs in os.walk(b1.root) for f in fs)
    files2 = sorted(f for _, _, fs in os.walk(b2.root) for f in fs)
    assert files1 == files2
    # per-sub-bundle idempotency markers all exist in the coalesced run
    study = next(s for s in rt2._specs)
    for lo in range(0, 24, 4):
        assert rt2.counters.once_exists(f"{study}/exec/s0/c0/{lo}_{lo + 4}")


def test_deferred_writes_under_four_workers_match_blocking(tmp_path):
    """The engine's write pipeline (deferred bundle writes on its writer
    thread, 4 workers leasing) writes what in-thread blocking writes do."""
    samples = np.random.default_rng(8).random((96, 5)).astype(np.float32)
    _, b1, ex1 = _run_study(str(tmp_path / "block"), 1, samples,
                            sim=jag_simulate, bundle=8, engine=None,
                            n_workers=4)
    _, b2, ex2 = _run_study(str(tmp_path / "defer"), 4, samples,
                            sim=jag_simulate, bundle=8, n_workers=4)
    d1, d2 = b1.load_all(), b2.load_all()
    assert len(d1["_sample_ids"]) == len(d2["_sample_ids"]) == 96
    for k in d1:
        assert _row_rel(d2[k], d1[k]) <= 1e-6, k
    assert ex2.stats["write_s"] > 0


def test_coalesced_poison_task_falls_back_per_task(tmp_path):
    """One failing sub-task must not sink its batch-mates."""
    rt = MerlinRuntime(workspace=str(tmp_path),
                       hierarchy=HierarchyCfg(max_fanout=8, bundle=2))
    done = []

    def step(ctx):
        if any(tuple(r) == (4, 6) for r in ctx.sub_ranges):
            raise RuntimeError("poison")
        done.append((ctx.lo, ctx.hi))

    rt.register("step", step)
    spec = StudySpec(name="p", steps=[Step(name="step", fn="step")])
    with WorkerPool(rt, n_workers=1, batch=8):
        rt.run(spec, np.zeros((8, 1), np.float32))
        deadline = time.monotonic() + 30
        covered = set()
        while time.monotonic() < deadline:
            covered = set()
            for lo, hi in done:
                covered.update(range(lo, hi))
            if covered >= set(range(8)) - {4, 5}:
                break
            time.sleep(0.05)
    assert covered >= set(range(8)) - {4, 5}


def test_nullsim_study_through_runtime_and_pool(tmp_path):
    """The quickstart's shape on the null simulator: one root message, 4
    workers expanding the hierarchy, every sample bundled once."""
    rt = MerlinRuntime(workspace=str(tmp_path),
                       hierarchy=HierarchyCfg(max_fanout=8, bundle=16))
    bundler = Bundler(str(tmp_path / "results"), files_per_leaf=4)
    ex = E.EnsembleExecutor(null_simulate, bundler, device=CPU)
    rt.register("simulate", ex.step_fn())
    spec = StudySpec(name="null", steps=[Step(name="simulate", fn="simulate")])
    with WorkerPool(rt, n_workers=4) as pool:
        sid = rt.run(spec, np.random.default_rng(0).random(
            (200, 3)).astype(np.float32))
        assert rt.wait(sid, timeout=60)
        assert pool.stats()["gen"] >= 1
    data = bundler.load_all()
    assert sorted(data["_sample_ids"]) == list(range(200))
    np.testing.assert_array_equal(data["y"], np.ones(200, np.float32))
    assert ex.stats["samples"] == 200


@pytest.mark.parametrize("sim", [jag_simulate, seir_simulate])
def test_quickstart_shaped_study_on_the_simulators(tmp_path, sim):
    d = 5 if sim is jag_simulate else 6
    samples = np.random.default_rng(1).random((64, d)).astype(np.float32)
    _, b, ex = _run_study(str(tmp_path), 1, samples, sim=sim, bundle=16,
                          n_workers=4)
    data = b.load_all()
    assert sorted(data["_sample_ids"]) == list(range(64))
    direct = E.EnsembleExecutor(sim, device=CPU).run_bundle(0, 64, samples)
    order = np.argsort(data["_sample_ids"])
    for k, v in direct.items():
        assert _row_rel(data[k][order], v) <= 1e-6, k


def test_url_brokers_build_the_reference_types(tmp_path):
    """``MerlinRuntime(broker=URL)`` goes through ``make_broker`` as in the
    reference: ``mem://`` and ``file://`` in process, ``tcp://`` a
    ``NetBroker``, ``shard://`` and lists of endpoints a ``ShardedBroker``;
    ``file://`` with an empty path and unknown schemes raise ValueError,
    as the reference's do."""
    from repro.core import netbroker as NB_ref
    from repro_torch.core import netbroker as NB
    from repro_torch.core.shardbroker import ShardedBroker
    rt = MerlinRuntime(broker="mem://", workspace=str(tmp_path / "m"))
    assert isinstance(rt.broker, InMemoryBroker)
    rt = MerlinRuntime(broker=f"file://{tmp_path / 'q'}",
                       workspace=str(tmp_path / "f"))
    assert isinstance(rt.broker, FileBroker)
    servers = [NB.BrokerServer(InMemoryBroker()).start() for _ in range(2)]
    try:
        urls = [s.address for s in servers]
        rt = MerlinRuntime(broker=urls[0], workspace=str(tmp_path / "t"))
        assert type(rt.broker).__name__ == "NetBroker"
        assert type(NB_ref.make_broker(urls[0])).__name__ == "NetBroker"
        hosts = ",".join(u[len("tcp://"):] for u in urls)
        for url in (f"shard://{hosts}", urls):
            rt = MerlinRuntime(broker=url, workspace=str(tmp_path / "s"))
            assert isinstance(rt.broker, ShardedBroker)
            assert type(NB_ref.make_broker(url)).__name__ == "ShardedBroker"
            b = rt.broker
            b.put(new_task("real", {}, queue="sims"))
            assert b.qsize(("sims",)) == 1
            b.ack(b.get(timeout=2, queues=("sims",)).tag)
            b.close()
    finally:
        for s in servers:
            s.stop()
    for url in ("file://", "nope://x", "tcp//a:1"):
        with pytest.raises(ValueError) as port_err:
            MerlinRuntime(broker=url, workspace=str(tmp_path / "x"))
        with pytest.raises(ValueError) as ref_err:
            NB_ref.make_broker(url)
        assert str(port_err.value) == str(ref_err.value)


def test_quickstart_entry_on_the_cpu(capsys):
    assert quickstart.main(["--device", "cpu", "--samples", "128"]) == 0
    import json
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["device"] == "cpu" and res["simulations"] == 128
    assert res["bundled_rows"] == 128
    assert res["captures"] <= len(E.bucket_schedule(quickstart.BUNDLE))
    assert np.isfinite(res["r2"])


# ---------------------------------------------------------------------------
# the surrogate against the reference
# ---------------------------------------------------------------------------

def _data(n=37, d=4, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.random((n, d)).astype(np.float32)
    y = (X[:, 0] - 0.3 * X[:, 1] ** 2).astype(np.float32)
    return X, y


def _ref_init(n_members, dims, seed):
    rngs = jnp.stack([jax.random.PRNGKey(seed * 131 + m)
                      for m in range(n_members)])
    return jax.vmap(lambda r: A_ref._mlp_init(r, dims))(rngs)


def _np_tree(stacked):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in stacked]


def _padded(X, y):
    cap = E.bucket_for(len(X))
    w = np.zeros(cap, np.float32)
    w[:len(X)] = 1.0
    return E.pad_rows(X, cap), E.pad_rows(y, cap), w


def _leaf_rel(port, ref):
    worst = 0.0
    for lp, lr in zip(port, ref):
        for k in ("w", "b"):
            p = lp[k].detach().cpu().numpy()
            r = np.asarray(lr[k])
            worst = max(worst, float(np.abs(p - r).max() / np.abs(r).max()))
    return worst


def test_surrogate_from_jax_keeps_the_members():
    params0 = _np_tree(_ref_init(3, (4, 16, 16, 1), 0))
    sur = convert.surrogate_from_jax(params0, CPU)
    assert len(sur.params_list) == 3
    for lp, lr in zip(sur.stacked, params0):
        for k in ("w", "b"):
            np.testing.assert_array_equal(lp[k].numpy(), lr[k])
    np.testing.assert_array_equal(sur.params_list[1][2]["w"].numpy(),
                                  params0[2]["w"][1])
    X, _ = _data(50)
    mu, sd = sur.predict(X)
    ref = A_ref.Surrogate.from_stacked(_ref_init(3, (4, 16, 16, 1), 0), 3)
    mu_r, sd_r = ref.predict(X)
    np.testing.assert_allclose(mu, mu_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sd, sd_r, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="stacked"):
        convert.surrogate_from_jax([{"w": np.zeros((4, 3)),
                                     "b": np.zeros(3)}], CPU)


@pytest.mark.parametrize("steps", [1, 10])
def test_fit_members_params_match_reference(steps):
    """From one init, the port's Adam steps give the reference's params at
    rel 1e-4 per leaf."""
    X, y = _data()
    Xp, yp, w = _padded(X, y)
    init = _ref_init(3, (4, 64, 64, 1), 0)
    ref = A_ref._fit_members(init, jnp.asarray(Xp), jnp.asarray(yp),
                             jnp.asarray(w), steps, 3e-3)
    port = A._fit_members(convert.surrogate_from_jax(_np_tree(init),
                                                     CPU).stacked,
                          torch.from_numpy(Xp), torch.from_numpy(yp),
                          torch.from_numpy(w), steps, 3e-3)
    assert _leaf_rel(port, ref) <= 1e-4


def test_trained_predictions_match_reference():
    """300 steps from one init: mean and std at 1e-3 of the largest
    magnitude."""
    X, y = _data()
    init = _ref_init(3, (4, 64, 64, 1), 0)
    Xp, yp, w = _padded(X, y)
    ref = A_ref.Surrogate.from_stacked(
        A_ref._fit_members(init, jnp.asarray(Xp), jnp.asarray(yp),
                           jnp.asarray(w), 300, 3e-3), 3)
    port = A.Surrogate.from_stacked(A._fit_members(
        convert.surrogate_from_jax(_np_tree(init), CPU).stacked,
        torch.from_numpy(Xp), torch.from_numpy(yp), torch.from_numpy(w),
        300, 3e-3), 3)
    grid = np.random.default_rng(6).random((50, 4)).astype(np.float32)
    mu_r, sd_r = ref.predict(grid)
    mu_p, sd_p = port.predict(grid)
    assert np.abs(mu_p - mu_r).max() <= 1e-3 * np.abs(mu_r).max()
    assert np.abs(sd_p - sd_r).max() <= 1e-3 * np.abs(mu_r).max()


def _train_eager_members(X, y, n_members=3, hidden=64, steps=60, lr=3e-3,
                         seed=0):
    """One member at a time on the unpadded rows, the plain mean loss:
    ground truth for the batched, masked fit."""
    X = torch.from_numpy(X)
    y = torch.from_numpy(y)
    members = []
    for m in range(n_members):
        layers = A._mlp_init(torch.Generator().manual_seed(seed * 131 + m),
                             (X.shape[1], hidden, hidden, 1))
        leaves = [t for layer in layers for t in (layer["w"], layer["b"])]
        mom = [torch.zeros_like(t) for t in leaves]
        vel = [torch.zeros_like(t) for t in leaves]
        for _ in range(steps):
            leaves = [t.detach().requires_grad_(True) for t in leaves]
            h = X
            for i in range(0, len(leaves), 2):
                h = h @ leaves[i] + leaves[i + 1]
                if i < len(leaves) - 2:
                    h = torch.nn.functional.gelu(h, approximate="tanh")
            g = torch.autograd.grad(((h[:, 0] - y) ** 2).mean(), leaves)
            with torch.no_grad():
                mom = [0.9 * a + 0.1 * b for a, b in zip(mom, g)]
                vel = [0.999 * a + 0.001 * b ** 2 for a, b in zip(vel, g)]
                leaves = [p - lr * a / (torch.sqrt(v) + 1e-8)
                          for p, a, v in zip(leaves, mom, vel)]
        members.append([{"w": leaves[i].detach(), "b": leaves[i + 1].detach()}
                        for i in range(0, len(leaves), 2)])
    return A.Surrogate(members)


def test_batched_training_matches_eager_member_loop():
    X, y = _data()      # 37 rows: forces masked padding to 64
    ref = _train_eager_members(X, y, steps=60)
    new = A.train_surrogate(X, y, steps=60, device=CPU)
    grid = np.random.default_rng(5).random((50, 4)).astype(np.float32)
    mu_ref, sd_ref = ref.predict(grid)
    mu_new, sd_new = new.predict(grid)
    np.testing.assert_allclose(mu_new, mu_ref, atol=2e-3)
    np.testing.assert_allclose(sd_new, sd_ref, atol=2e-3)
    for pr, pn in zip(ref.params_list, new.params_list):
        for lr_, ln_ in zip(pr, pn):
            np.testing.assert_allclose(ln_["w"].numpy(), lr_["w"].numpy(),
                                       atol=2e-3)


def test_train_surrogate_across_sizes_in_one_bucket():
    rng = np.random.default_rng(6)
    X = rng.random((70, 3)).astype(np.float32)
    y = X.sum(1).astype(np.float32)
    s1 = A.train_surrogate(X[:65], y[:65], steps=30, device=CPU)
    s2 = A.train_surrogate(X, y, steps=30, device=CPU)  # both pad to 128
    for s in (s1, s2):
        mu, sd = s.predict(X)
        assert mu.shape == (70,) and sd.shape == (70,)
        assert (sd >= 0).all()


def test_same_seed_same_members_on_any_device():
    a = A.init_members(2, (3, 8, 8, 1), 4, CPU)
    b = A.init_members(2, (3, 8, 8, 1), 4, CPU)
    c = A.init_members(2, (3, 8, 8, 1), 5, CPU)
    for la, lb, lc in zip(a, b, c):
        assert torch.equal(la["w"], lb["w"])
    assert not torch.equal(a[0]["w"], c[0]["w"])
    assert not torch.equal(a[0]["w"][0], a[0]["w"][1])


# ---------------------------------------------------------------------------
# snapshot, acquisition and the loop
# ---------------------------------------------------------------------------

def test_snapshot_refreshes_on_new_bundles(tmp_path):
    b = Bundler(str(tmp_path))
    X, y = _data(40, 3)
    b.write_bundle(0, 20, {"inputs": X[:20], "yield": y[:20]})
    snap = A.SurrogateSnapshot(str(tmp_path), n_members=2, hidden=16,
                               steps=20, device=CPU)
    assert snap.version == 1 and snap.rows == 20 and snap.dims == 3
    assert not snap.refresh()
    b.write_bundle(20, 40, {"inputs": X[20:], "yield": y[20:]})
    assert snap.refresh() and snap.version == 2 and snap.rows == 40
    mu, sd = snap.predict(X[:5])
    assert mu.shape == (5,) and sd.shape == (5,)


def test_propose_batch_splits_three_ways():
    X, y = _data(64, 5)
    sur = A.train_surrogate(X, y, steps=20, hidden=16, device=CPU)
    Xn = A.propose_batch(sur, sur, X, y, 12, 5, con_max=10.0, seed=1)
    assert Xn.shape == (12, 5) and Xn.dtype == np.float32
    assert (Xn >= 0).all() and (Xn <= 1).all()
    r = A.robust_objective(sur, X[:4], n_perturb=8)
    assert r.shape == (4,)


def test_optimization_loop_runs_its_iterations(tmp_path):
    rt = MerlinRuntime(workspace=str(tmp_path),
                       hierarchy=HierarchyCfg(max_fanout=8, bundle=8))
    loop = A.OptimizationLoop(rt, jag_simulate, batch_per_iter=24,
                              max_iters=2, device=CPU)
    with WorkerPool(rt, n_workers=2):
        loop.start()
        deadline = time.monotonic() + 120
        while len(loop.history) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
    assert [h["iter"] for h in loop.history] == [0, 1]
    assert all(h["n"] > 0 and np.isfinite(h["best"]) for h in loop.history)
    assert len(loop.bundler.load_all()["_sample_ids"]) == 48


def _late_copy_tree(tmp_path, perturb=0.0):
    """Three bundles aggregated, then the middle one written once more (a
    redelivered task finishing after the aggregate step)."""
    rng = np.random.default_rng(5)
    y = rng.random(30).astype(np.float32)
    y[4] = np.nan
    img = rng.random((30, 2, 3)).astype(np.float32)
    b = Bundler(str(tmp_path / "jag"), files_per_leaf=100)
    for lo in (0, 10, 20):
        b.write_bundle(lo, lo + 10, {"yield": y[lo:lo + 10],
                                     "images": img[lo:lo + 10]})
    assert len(b.aggregate_all()) == 1
    b.write_bundle(10, 20, {"yield": y[10:20] * (1 + perturb),
                            "images": img[10:20]})
    return b, y, img


def test_icf_rows_keep_one_copy_of_a_sample_written_twice(tmp_path):
    b, y, img = _late_copy_tree(tmp_path)
    present, _ = b.crawl()
    loaded = b.load_all()
    assert len(present) == 30 and len(loaded["_sample_ids"]) == 40
    data, dup, agree = icf_ensemble.dedupe_rows(loaded)
    assert (dup, agree) == (10, True)
    np.testing.assert_array_equal(data["_sample_ids"], np.arange(30))
    np.testing.assert_array_equal(data["yield"], y)
    np.testing.assert_array_equal(data["images"], img)
    # a tree without copies comes back as it was
    same, dup, agree = icf_ensemble.dedupe_rows(data)
    assert same is data and (dup, agree) == (0, True)


def test_icf_rows_flag_copies_that_differ(tmp_path):
    b, _, _ = _late_copy_tree(tmp_path, perturb=1e-3)
    _, dup, agree = icf_ensemble.dedupe_rows(b.load_all())
    assert (dup, agree) == (10, False)


def test_icf_entry_on_the_cpu():
    res = icf_ensemble.run_icf(CPU, 200, log=lambda line: None)
    assert res["on_disk"] == res["rows"] == 200
    assert res["duplicates_agree"]
    assert res["passes"][-1] == 200 and res["n_aggregates"] >= 1
