"""The Merlin quickstart on the port (after ``examples/quickstart.py``, with
the in-process broker):

    python -m repro_torch.launch.quickstart [--device cpu] [--samples 512]

1. a study (simulate) over JAG ICF samples drawn from a seed;
2. run through ``MerlinRuntime`` and a ``WorkerPool`` of 4 workers (one
   root message enqueued; workers expand the task hierarchy), each bundle
   through the ``EnsembleExecutor`` (one CUDA graph a bucket on the card)
   into a ``Bundler``;
3. a deep-ensemble surrogate trained on half the bundled rows, scored by
   its R² on the other half.

Runs on the card unless ``--device cpu`` is given, and raises when no card
is visible.  Prints one JSON line: bundles, simulations, ``sim_time``,
graph captures and the surrogate's R².
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch import env
from repro_torch.core import (Bundler, EnsembleExecutor, MerlinRuntime, Step,
                              StudySpec, WorkerPool)
from repro_torch.core.active import Surrogate, train_surrogate
from repro_torch.core.ensemble import trace_count
from repro_torch.core.hierarchy import HierarchyCfg
from repro_torch.data.pipeline import regression_dataset
from repro_torch.sim import jag_sample_inputs, jag_simulate


WORKERS = 4      # surge-able worker threads
BUNDLE = 64      # samples a leaf task
STEPS = 400      # surrogate training steps
TIMEOUT_S = 300.0


def r2_score(mu: np.ndarray, y: np.ndarray) -> float:
    return 1.0 - float(np.mean((mu - y) ** 2)) / float(np.var(y))


def run_study(device=None, samples: int = 512
              ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray], Surrogate]:
    """Run the quickstart study; returns (summary, the bundled archive as
    ``Bundler.load_all`` gives it, the trained surrogate)."""
    dev = env.device(device)
    with tempfile.TemporaryDirectory() as ws:
        rt = MerlinRuntime(workspace=ws,
                           hierarchy=HierarchyCfg(max_fanout=8, bundle=BUNDLE))
        bundler = Bundler(os.path.join(ws, "results"), files_per_leaf=4)
        executor = EnsembleExecutor(jag_simulate, bundler, device=dev)
        rt.register("simulate", executor.step_fn())
        spec = StudySpec(name="quickstart", steps=[
            Step(name="simulate", fn="simulate")])
        X0 = jag_sample_inputs(0, samples).numpy()

        captures0 = trace_count()
        t0 = time.monotonic()
        with WorkerPool(rt, n_workers=WORKERS) as pool:
            study = rt.run(spec, X0)  # `merlin run`: one message
            if not rt.wait(study, timeout=TIMEOUT_S):
                raise RuntimeError(f"study did not finish in {TIMEOUT_S} s")
            bundles = pool.stats()["real"]
        study_s = time.monotonic() - t0
        data = bundler.load_all()

    X, y = regression_dataset(data, target="yield")
    n = len(X)
    t1 = time.monotonic()
    sur = train_surrogate(X[: n // 2], y[: n // 2], steps=STEPS, device=dev)
    mu, _ = sur.predict(X[n // 2:])
    train_s = time.monotonic() - t1
    summary = {
        "device": env.device_name(dev),
        "samples": samples, "workers": WORKERS,
        "bundles": bundles,
        "simulations": executor.stats["samples"],
        "bundled_rows": int(len(data.get("_sample_ids", []))),
        "sim_time": executor.stats["sim_time"],
        "write_s": executor.stats["write_s"],
        "launches": executor.stats["launches"],
        "captures": trace_count() - captures0,
        "study_s": study_s,
        "n_train": n // 2,
        "surrogate_steps": STEPS,
        "surrogate_s": train_s,
        "r2": r2_score(mu, y[n // 2:]),
    }
    return summary, data, sur


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.quickstart")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--samples", type=int, default=512)
    args = ap.parse_args(argv)
    summary, _, _ = run_study(args.device, samples=args.samples)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
