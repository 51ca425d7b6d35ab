"""The 100M-JAG Sierra study (paper Sec. 3.1) on the port, scaled to one
card (after ``examples/icf_ensemble.py``).

    python -m repro_torch.launch.icf_ensemble [n_samples] [--device cpu]

Every mechanism of the original at 1/10000 scale:
  * a YAML study spec (simulate -> aggregate funnel; ``specs/
    icf_ensemble.yaml``, a copy of the reference's),
  * hierarchical task generation from ONE enqueued message,
  * bundles of 10 simulations fused a task (one CUDA graph a bucket),
    hierarchical npz bundling (100 files a leaf),
  * injected worker failures (30 % of deliveries: the "volatile
    early-access period"),
  * crawl-and-resubmit recovery passes: completion goes ~70% -> 100%,
    mirroring the paper's 70% -> 85% -> 99.755% arc.

Runs on the card unless ``--device cpu`` is given; raises when no card is
visible.  Prints the reference's lines, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch import env
from repro_torch.core import (Bundler, EnsembleExecutor, MerlinRuntime,
                              StudySpec, WorkerPool)
from repro_torch.core.hierarchy import HierarchyCfg
from repro_torch.core.resilience import crawl_and_resubmit
from repro_torch.sim import jag_sample_inputs, jag_simulate

SPEC_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "specs",
                         "icf_ensemble.yaml")
N_SAMPLES = 10_000
FAILURE_RATE = 0.3
# a sample's two copies, relative to the field's largest magnitude
DUPLICATE_RTOL = 1e-5


def dedupe_rows(data: Dict[str, np.ndarray]
                ) -> Tuple[Dict[str, np.ndarray], int, bool]:
    """One row a sample id: ``(data, duplicate rows dropped, whether every
    duplicate equals the row kept)``.

    Delivery is at-least-once: a task whose lease expires while it still
    runs is run again.  Its second bundle file is harmless until the
    aggregate step has merged the first copy into ``aggregate.npz``; a copy
    written after that leaves the same ids in two files, and ``load_all``
    returns both.  The simulation
    is a function of the sample, so the copies must agree: integers exactly,
    floats within ``DUPLICATE_RTOL`` of the field's largest magnitude (the
    two copies may have run in batches of other sizes), NaN where NaN."""
    ids = data["_sample_ids"]
    uniq, first, inverse = np.unique(ids, return_index=True,
                                     return_inverse=True)
    if len(uniq) == len(ids):
        return data, 0, True

    def same(v: np.ndarray) -> bool:
        kept = v[first][inverse]
        if v.dtype.kind not in "fc":
            return bool(np.array_equal(v, kept))
        scale = float(np.nanmax(np.abs(v), initial=0.0))
        return bool(np.allclose(v, kept, rtol=0.0,
                                atol=DUPLICATE_RTOL * scale, equal_nan=True))
    agree = all(same(v) for v in data.values())
    return ({k: v[first] for k, v in data.items()}, len(ids) - len(uniq),
            agree)


def run_icf(device=None, n_samples: int = N_SAMPLES,
            log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Run the study; returns the counts of each pass, the final count on
    disk, the physics failures, the device's sims/s and the wall."""
    dev = env.device(device)
    with tempfile.TemporaryDirectory() as ws:
        rt = MerlinRuntime(workspace=ws,
                           hierarchy=HierarchyCfg(max_fanout=16, bundle=10))
        bundler = Bundler(f"{ws}/jag", files_per_leaf=100)
        executor = EnsembleExecutor(jag_simulate, bundler, device=dev)
        rt.register("simulate", executor.step_fn())
        agg_stats: Dict[str, Optional[int]] = {}

        def aggregate(ctx):
            outs = bundler.aggregate_all()
            agg_stats["n_aggregates"] = len(outs)
        rt.register("aggregate", aggregate)

        with open(SPEC_PATH) as f:
            spec = StudySpec.from_yaml(f.read())
        samples = jag_sample_inputs(0, n_samples).numpy()

        # the reference sets a 1 s visibility timeout "for dead workers";
        # an injected death nacks at once, so that timeout only ever
        # expires on a task that is still running: the aggregate step
        # (seconds of compression at 10,000 samples) then runs twice at
        # once, and two aggregations of one leaf can lose rows or race
        # the final crawl.  The broker's default outlasts every task.
        t0 = time.time()
        passes = []
        # 30% worker death rate: the "volatile early access period"
        with WorkerPool(rt, n_workers=4, failure_rate=FAILURE_RATE,
                        seed=3) as pool:
            study = rt.run(spec, samples)
            # the reference waits with rt.wait(study, timeout=600) and then
            # drains; when a leaf has used up its retries the study cannot
            # complete, and that wait runs out its whole timeout.  Waiting
            # for the broker to go idle ends at the same state, sooner:
            # nothing is left to run until the crawl resubmits.
            pool.drain(timeout=600)
            present, corrupt = bundler.crawl()
            passes.append(len(present))
            log(f"pass 1: {len(present)}/{n_samples} "
                f"({100 * len(present) / n_samples:.1f}%) complete, "
                f"{rt.broker.stats['redelivered']} redeliveries, "
                f"{time.time() - t0:.1f}s")

            # recovery passes: crawl the tree, resubmit missing work
            tmpl = {"study": study, "stage": 0, "combo": 0,
                    "n_samples": n_samples, "fanout": 16, "bundle": 10}
            for p in range(2, 6):
                missing, ntasks = crawl_and_resubmit(
                    bundler, n_samples, rt.broker, tmpl, bundle=10)
                if missing == 0:
                    break
                pool.drain(timeout=120)
                present, _ = bundler.crawl()
                passes.append(len(present))
                log(f"pass {p}: resubmitted {ntasks} tasks -> "
                    f"{len(present)}/{n_samples} "
                    f"({100 * len(present) / n_samples:.2f}%)")
        wall = time.time() - t0
        # the final count is crawled once the pool has stopped: the
        # reference reports the loop's last crawl, which can run while the
        # aggregate step merges bundle files and so miss some of them
        present, _ = bundler.crawl()

        data, duplicates, agree = dedupe_rows(bundler.load_all())
        ok = np.isfinite(data["yield"])
        rate = executor.stats["samples"] / max(executor.stats["sim_time"], 1e-9)
        res = {"device": env.device_name(dev), "n_samples": n_samples,
               "passes": passes, "on_disk": len(present),
               "rows": int(len(data["yield"])),
               "duplicate_rows": duplicates, "duplicates_agree": agree,
               "physics_failures": int((~ok).sum()),
               "physics_failure_pct": float(100 * (~ok).mean()),
               "image_mib": data["images"].nbytes / 2**20,
               "n_aggregates": agg_stats.get("n_aggregates", 0),
               "redelivered": rt.broker.stats["redelivered"],
               "simulations": executor.stats["samples"],
               "sim_time": executor.stats["sim_time"],
               "sims_per_s": rate, "wall_s": wall}
    log(f"final: {res['on_disk']}/{n_samples} on disk; "
        f"{res['physics_failures']} internal physics failures "
        f"({res['physics_failure_pct']:.2f}%, cf. paper's 0.22%)")
    log(f"dataset: {res['image_mib']:.0f} MiB of images, "
        f"{res['n_aggregates']} aggregate files, "
        f"device throughput {rate:.0f} sims/s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.icf_ensemble")
    ap.add_argument("n_samples", nargs="?", type=int, default=N_SAMPLES)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run_icf(args.device, args.n_samples)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
