"""The port's workflow archetypes and Merlin CLIs against the reference, on
the CPU.

* The COVID calibrate->forecast cascade (``core/cascade.py``): the case of
  ``tests/test_workflows.py`` (it calibrates, and NPIs lower the median
  peak) on the port; its ``spec()`` and compiled DAG equal the reference's;
  its select and package steps on the same bundles give the same posterior
  and the same quantile bands.
* ``merlin-validate`` over ``examples/specs/*.yaml`` prints what the
  reference prints; ``main`` dispatches each subcommand as the reference's
  does; ``merlin-dlq`` list, show and requeue print what the reference's
  do on the same queues.
* ``python -m repro_torch.launch.quickstart --two-process --device cpu`` in
  a subprocess, with a bounded wait.

The cases of ``tests/test_serve_tools.py`` run against the port in
``test_torch_ref_serve_tools.py``."""
import dataclasses
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.bundler import Bundler as Bundler_ref
from repro.core.cascade import CalibrationCascade as Cascade_ref
from repro.core.dag import compile_dag as compile_dag_ref
from repro.core.queue import FileBroker as FileBroker_ref
from repro.core.queue import Task as Task_ref
from repro.core.runtime import MerlinRuntime as Runtime_ref
from repro.launch import serve as serve_ref
from repro_torch.core import MerlinRuntime, WorkerPool
from repro_torch.core.bundler import Bundler
from repro_torch.core.cascade import CalibrationCascade
from repro_torch.core.dag import compile_dag
from repro_torch.core.hierarchy import HierarchyCfg
from repro_torch.core.queue import FileBroker, Task
from repro_torch.launch import serve
from repro_torch.sim import seir_simulate
from repro_torch.sim.epidemic import seir_draws

ROOT = Path(__file__).resolve().parents[1]
SPECS = sorted(str(p) for p in (ROOT / "examples" / "specs").glob("*.yaml"))


def test_cascade_calibrates_then_forecasts(tmp_path):
    """The reference's case, with the ground truth from the port's SEIR and
    row seed 1, on the CPU."""
    rng = np.random.default_rng(0)
    truth = {}
    for m in ["NYC", "SEA"]:
        u = rng.uniform(0.3, 0.7, 6).astype(np.float32)
        truth[m] = seir_simulate(torch.from_numpy(u[None]), seir_draws(
            torch.tensor([1])))["daily_cases"][0].numpy()
    rt = MerlinRuntime(workspace=str(tmp_path),
                       hierarchy=HierarchyCfg(max_fanout=4, bundle=16))
    casc = CalibrationCascade(rt, seir_simulate, truth, n_calib=32,
                              n_posterior=8, device="cpu")
    with WorkerPool(rt, n_workers=2) as pool:
        casc.start()
        t0 = time.time()
        while time.time() - t0 < 240:
            if all(len(casc.results.get(m, {})) >= 4 for m in truth):
                break
            time.sleep(0.2)
        pool.drain(timeout=60)
    for m in truth:
        r = casc.results[m]
        assert "posterior_rmse" in r
        # NPIs reduce the peak monotonically
        assert r["strong_npi"]["peak_median"] <= \
            r["baseline"]["peak_median"] + 1e-6


OBSERVED = {m: np.linspace(0, 30, 60) * (i + 1)
            for i, m in enumerate(["ATL", "NYC", "SEA"])}


def _cascades(tmp_path):
    port = CalibrationCascade(
        MerlinRuntime(workspace=str(tmp_path / "port")), seir_simulate,
        OBSERVED, n_calib=40, n_posterior=6, device="cpu")
    ref = Cascade_ref(Runtime_ref(workspace=str(tmp_path / "ref")),
                      lambda u, key: {}, OBSERVED, n_calib=40,
                      n_posterior=6)
    return port, ref


def test_cascade_spec_and_dag_equal_the_reference(tmp_path):
    port, ref = _cascades(tmp_path)
    assert dataclasses.asdict(port.spec()) == dataclasses.asdict(ref.spec())
    dag, dag_ref = compile_dag(port.spec()), compile_dag_ref(ref.spec())
    assert dag.to_doc() == dag_ref.to_doc()
    insts = dag.all_instances()
    assert insts == dag_ref.all_instances()
    assert [dag.instance_parents(*i) for i in insts] == \
        [dag_ref.instance_parents(*i) for i in insts]


def _ctx(combo, workspace, published):
    return types.SimpleNamespace(
        combo=combo, workspace=workspace,
        publish_samples=lambda name, arr: published.append((name, arr)))


def test_cascade_select_and_package_equal_the_reference(tmp_path):
    """The same calibration and forecast bundles on both sides: the same
    posterior rows and RMSE, the same medians and quantile bands."""
    port, ref = _cascades(tmp_path)
    rng = np.random.default_rng(11)
    n = 40
    for m, obs in OBSERVED.items():
        calib = {"inputs": rng.random((n, 6)).astype(np.float32),
                 "daily_cases": (obs[None] * rng.uniform(0.5, 1.5, (n, 1))
                                 ).astype(np.float32)}
        fc = {"daily_cases": rng.gamma(2.0, 10.0, (n, 60)).astype(np.float32),
              "peak_cases": rng.gamma(2.0, 30.0, n).astype(np.float32),
              "attack_rate": rng.random(n).astype(np.float32)}
        for casc, bundler in ((port, Bundler), (ref, Bundler_ref)):
            ws = casc.rt.workspace
            for lo in range(0, n, 16):
                hi = min(n, lo + 16)
                bundler(os.path.join(ws, "epi", "calib", m)).write_bundle(
                    lo, hi, {k: v[lo:hi] for k, v in calib.items()})
                bundler(os.path.join(ws, "epi", "fc_strong_npi", m)
                        ).write_bundle(lo, hi, {k: v[lo:hi]
                                                for k, v in fc.items()})
        pub, pub_ref = [], []
        port._select_step(_ctx({"METRO": m}, None, pub))
        ref._select_step(_ctx({"METRO": m}, None, pub_ref))
        assert pub[0][0] == pub_ref[0][0] == "posterior"
        np.testing.assert_array_equal(pub[0][1], pub_ref[0][1])
        assert pub[0][1].shape == (6, 6)
        combo = {"METRO": m, "SCENARIO": "strong_npi"}
        outs = []
        for casc in (port, ref):
            ws = os.path.join(casc.rt.workspace, "out", m)
            os.makedirs(ws)
            casc._package_step(_ctx(combo, ws, []))
            with open(os.path.join(ws, "forecast.json")) as f:
                outs.append(json.load(f))
        assert outs[0] == outs[1]
        assert len(outs[0]["q50"]) == 60
    assert port.results == ref.results


def test_merlin_validate_prints_what_the_reference_prints(capsys):
    assert len(SPECS) == 3
    for extra in ([], ["--json"]):
        assert serve_ref.merlin_validate_main(SPECS + extra) == 0
        want = capsys.readouterr().out
        assert serve.merlin_validate_main(SPECS + extra) == 0
        assert capsys.readouterr().out == want
    bad = os.path.join(os.path.dirname(SPECS[0]), "missing.yaml")
    assert serve_ref.merlin_validate_main([bad, "--json"]) == 1
    want = capsys.readouterr().out
    assert serve.main(["merlin-validate", bad, "--json"]) == 1
    assert capsys.readouterr().out == want


def test_main_dispatches_as_the_reference(monkeypatch):
    seen = []
    names = ["merlin_serve_main", "broker_serve_main", "merlin_status_main",
             "merlin_validate_main", "merlin_dlq_main", "merlin_scale_main",
             "llm_serve_main"]
    for mod in (serve, serve_ref):
        for name in names:
            monkeypatch.setattr(mod, name, lambda argv, name=name, mod=mod:
                                seen.append((mod.__name__, name, argv)))
    for argv in (["merlin-serve", "--study", "d"], ["broker-serve"],
                 ["merlin-status", "--broker", "mem://"],
                 ["merlin-validate", "a.yaml"], ["merlin-dlq", "list"],
                 ["merlin-scale", "--plan"], ["--arch", "jag-surrogate"], []):
        serve.main(argv)
        serve_ref.main(argv)
    port = [s[1:] for s in seen if s[0] == serve.__name__]
    assert port == [s[1:] for s in seen if s[0] == serve_ref.__name__]
    assert port[0] == ("merlin_serve_main", ["--study", "d"])
    assert port[-2:] == [("llm_serve_main", ["--arch", "jag-surrogate"]),
                         ("llm_serve_main", [])]


def _seed_dlq(root, broker_cls, task_cls):
    b = broker_cls(root)
    b.put(task_cls(id="t-live", kind="real", payload={}, queue="sims"))
    for i in range(3):
        b.put(task_cls(id=f"t-dead{i}", kind="real",
                       payload={"study": "s1"}, queue="dlq.sims",
                       retries=3))
    b.put(task_cls(id="p-dead", kind="real", payload={"study": "s2"},
                   queue="dlq.post", retries=5))


def test_merlin_dlq_prints_what_the_reference_prints(tmp_path, capsys):
    _seed_dlq(str(tmp_path / "port"), FileBroker, Task)
    _seed_dlq(str(tmp_path / "ref"), FileBroker_ref, Task_ref)
    for args in (["list"], ["list", "--json"], ["show", "--json"], ["show"],
                 ["requeue", "--queue", "post", "--json"], ["list"],
                 ["requeue"], ["list", "--json"]):
        outs = []
        for main, d in ((serve_ref.main, "ref"), (serve.main, "port")):
            assert main(["merlin-dlq", "--broker",
                         f"file://{tmp_path / d}", *args]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0], args
    assert FileBroker(str(tmp_path / "port")).qsize(("sims",)) == 4
    assert FileBroker(str(tmp_path / "port")).qsize(("post",)) == 1


@pytest.mark.net
def test_quickstart_two_process_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_AUTH_TOKEN", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.quickstart",
         "--two-process", "--device", "cpu", "--samples", "128"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=240)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(line) for line in out.stdout.splitlines()
             if line.startswith("{")]
    assert lines[0]["event"] == "listening"
    res = lines[-1]
    assert res["device"] == "cpu" and res["broker"] == "NetBroker"
    assert res["simulations"] == res["bundled_rows"] == 128
