"""The executor's multi-device dispatch against one device.

The reference's equivalence (``tests/test_engine.py``): bundles of
[32, 32, 16, 5] rows through ``shard_map`` over 8 forced host devices give
the single-device outputs bit for bit for an IEEE-exact simulator and
within rel 1e-3 for JAG, with every path inside the bucket bound and the
sharded streams on the mesh.  The port's mesh is a tuple of devices; four
CPU devices split every bucket of these sizes (32, 32, 16 and 5's bucket
8) as the reference's eight do.  The two frameworks draw different random
numbers (``sim/rng.py``), so each side is held to its own single-device
run, by the reference's own assertions.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import ensemble as E
from repro_torch.sim import jag_simulate
from repro_torch.sim import rng as R

CPU = torch.device("cpu")
SIZES = [32, 32, 16, 5]
MESH = (CPU,) * 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def exact_sim(u, draws):
    """The reference's IEEE-exact simulator (add/mul/div/sqrt and
    counter-based uniform bits only)."""
    s = u * 2.0 + 0.25
    return {"v": s / (1.0 + u) + draws["noise"] * 0.001,
            "w": torch.sqrt(s),
            "s": (u * u).sum(-1)}


exact_sim.draws_fn = lambda seeds, device=None: {
    "noise": R.uniform(seeds, 0, 5)}


def _stream(ex):
    blocks = [np.random.default_rng(5).random((s, 5)).astype(np.float32)
              for s in SIZES]
    traces, lo, out = E.trace_count(), 0, []
    for blk in blocks:
        out.append(ex.run_bundle(lo, lo + len(blk), blk))
        lo += len(blk)
    return out, E.trace_count() - traces


def test_device_mesh_is_none_without_a_card():
    if torch.cuda.device_count() > 1:
        pytest.skip("this host has several cards")
    assert E.device_mesh() is None
    ex = E.EnsembleExecutor(exact_sim, device=CPU, mesh="auto")
    assert ex.mesh is None and ex.stats["devices"] == 1
    out = ex.run_bundle(0, 3, np.zeros((3, 5), np.float32))
    assert out["v"].shape == (3, 5)
    assert ex.stats["mesh_launches"] == 0


@pytest.mark.parametrize("sim,exact", [(exact_sim, True),
                                       (jag_simulate, False)])
def test_split_over_four_devices_matches_one(sim, exact):
    bound = int(math.ceil(math.log2(max(SIZES)))) + 1
    single, t1 = _stream(E.EnsembleExecutor(sim, device=CPU, mesh=None,
                                            share_cache=False))
    ex = E.EnsembleExecutor(sim, device=CPU, mesh=MESH, share_cache=False)
    split, t2 = _stream(ex)
    assert ex.stats["devices"] == 4
    # 32, 32, 16 and the 5 -> 8 bucket all divide four devices
    assert ex.stats["mesh_launches"] == 4 >= 3
    assert t1 <= bound and t2 <= bound
    rel = 0.0
    for a, b in zip(single, split):
        assert set(a) == set(b)
        for k in a:
            assert a[k].shape == b[k].shape
            if exact:
                assert np.array_equal(a[k], b[k], equal_nan=True), k
            m = np.isfinite(a[k])
            d = np.abs(a[k] - b[k])[m] / np.maximum(np.abs(a[k][m]), 1e-30)
            rel = max(rel, float(d.max()) if d.size else 0.0)
    assert rel <= 1e-3


def test_small_bucket_runs_on_one_device():
    ex = E.EnsembleExecutor(exact_sim, device=CPU, mesh=MESH,
                            share_cache=False)
    one = E.EnsembleExecutor(exact_sim, device=CPU, mesh=None,
                             share_cache=False)
    x = np.random.default_rng(1).random((3, 5)).astype(np.float32)
    got = ex.run_bundle(7, 10, x)  # bucket 4 divides; bucket 2 does not
    want = one.run_bundle(7, 10, x)
    for k in want:
        assert np.array_equal(got[k], want[k])
    assert ex.stats["mesh_launches"] == 1
    ex.run_bundle(0, 2, x[:2])
    assert ex.stats["mesh_launches"] == 1 and ex.stats["launches"] == 2


def test_reference_equivalence_holds_on_the_same_sizes():
    """The reference's forced-8-device run of the same sizes, as
    ``tests/test_engine.py`` runs it: the port's split above passes the
    same checks, with as many mesh launches and the same bucket bound."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run(
        [sys.executable, "-m", "benchmarks.ensemble_throughput",
         "--mesh-worker", json.dumps({"sizes": SIZES})],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-1000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    assert ref["bit_equal"] is True and ref["jag_max_rel_diff"] <= 1e-3
    assert ref["bucket_bound"] == int(math.ceil(math.log2(max(SIZES)))) + 1
    ex = E.EnsembleExecutor(exact_sim, device=CPU, mesh=MESH,
                            share_cache=False)
    _, traces = _stream(ex)
    assert ex.stats["mesh_launches"] == ref["exact_sharded"]["mesh_launches"]
    assert traces <= ref["bucket_bound"]
