"""COVID-19 intervention study on the port (paper Sec. 3.3; after
``examples/covid_calibration.py``): the calibrate->forecast cascade on the
epicast-like SEIR model as ONE declarative DAG (presim -> select ->
forecast -> package; ``core/cascade.py``).

    python -m repro_torch.launch.covid_calibration [--device cpu]

Three metros are calibrated against synthetic "observed" case curves
(ground-truth SEIR runs with 5 % noise): 128 parameter draws a metro in
bundles of 32, the 24 closest kept as the posterior, each posterior
forecast under three NPI scenarios.  Three workers.  Every ensemble runs on
the card (one CUDA graph a bucket) unless ``--device cpu`` is given; raises
when no card is visible.  Prints the reference's table, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import env
from repro_torch.core import MerlinRuntime, WorkerPool
from repro_torch.core.cascade import CalibrationCascade
from repro_torch.core.hierarchy import HierarchyCfg
from repro_torch.sim import seir_simulate
from repro_torch.sim.epidemic import seir_draws

METROS = ["NYC", "SEA", "ATL"]
N_CALIB = 128
N_POSTERIOR = 24
BUNDLE = 32
WORKERS = 3
TIMEOUT_S = 600.0


def synth_observations(seed: int = 0, device=None) -> Dict[str, np.ndarray]:
    """Ground-truth runs standing in for the live case-data pull: metro i's
    curve is one SEIR run at a uniform draw in [0.25, 0.75]^6, with the
    draws of row seed 100 + i, times 5 % noise."""
    dev = env.device(device)
    rng = np.random.default_rng(seed)
    obs = {}
    for i, m in enumerate(METROS):
        u = rng.uniform(0.25, 0.75, 6).astype(np.float32)
        out = seir_simulate(torch.from_numpy(u[None]).to(dev),
                            seir_draws(torch.tensor([100 + i]), dev))
        curve = out["daily_cases"][0].cpu().numpy()
        obs[m] = curve * rng.normal(1.0, 0.05, curve.shape)
    return obs


def run_cascade(device=None, observed: Optional[Dict[str, np.ndarray]] = None
                ) -> Tuple[Dict[str, Any], Dict[str, Dict[str, np.ndarray]]]:
    """Run the cascade; returns (``CalibrationCascade.results`` with the
    wall in ``"wall_s"``, each metro's calibration bundles as
    ``Bundler.load_all`` gives them).  Raises if it does not finish."""
    dev = env.device(device)
    if observed is None:
        observed = synth_observations(device=dev)
    with tempfile.TemporaryDirectory() as ws:
        rt = MerlinRuntime(workspace=ws,
                           hierarchy=HierarchyCfg(max_fanout=8, bundle=BUNDLE))
        casc = CalibrationCascade(rt, seir_simulate, observed,
                                  n_calib=N_CALIB, n_posterior=N_POSTERIOR,
                                  device=dev)
        n_results = 1 + len(casc.scenarios)  # posterior_rmse + scenarios
        t0 = time.time()
        with WorkerPool(rt, n_workers=WORKERS) as pool:
            casc.start()
            while time.time() - t0 < TIMEOUT_S:
                if all(len(casc.results.get(m, {})) >= n_results
                       for m in observed):
                    break
                time.sleep(0.05)
            pool.drain(timeout=120)
        wall = time.time() - t0
        missing = [m for m in observed
                   if len(casc.results.get(m, {})) < n_results]
        if missing:
            raise RuntimeError(f"cascade did not finish for {missing} in "
                               f"{TIMEOUT_S} s")
        calib = {m: casc._bundler("calib", m).load_all() for m in observed}
    return {**casc.results, "wall_s": wall}, calib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.covid_calibration")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    res, _ = run_cascade(args.device)
    print(f"calibrate->forecast cascade finished in {res['wall_s']:.1f}s")
    print(f"{'metro':<6}{'cal RMSE':>10} | peak cases/day by scenario")
    for m in METROS:
        r = res[m]
        scen = "  ".join(f"{s}={r[s]['peak_median']:.0f}"
                         for s in sorted(r) if s != "posterior_rmse")
        print(f"{m:<6}{r['posterior_rmse']:>10.2f} | {scen}")
    print(json.dumps({"device": env.device_name(env.device(args.device)),
                      **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
