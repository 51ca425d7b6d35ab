"""ML-augmented optimization of a fusion design on the port (paper Sec.
3.2; after ``examples/optimization_loop.py``).

    python -m repro_torch.launch.optimization_loop [--device cpu]

Re-optimizes JAG capsule inputs for maximum *robust* yield (expected yield
under manufacturing perturbations) subject to an implosion-velocity
constraint, via the self-re-enqueueing Merlin workflow of
``core/active.OptimizationLoop``: simulate -> train surrogates ->
constrained acquisition -> next batch, 96 designs an iteration, 4
iterations, 3 workers, each iteration launched from inside a worker task.
Simulations and surrogates run on the card unless ``--device cpu`` is
given; raises when no card is visible.  Prints the reference's table,
then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import Any, Dict, List, Tuple

from repro_torch import env
from repro_torch.core import MerlinRuntime, WorkerPool
from repro_torch.core.active import OptimizationLoop
from repro_torch.core.hierarchy import HierarchyCfg
from repro_torch.sim import jag_simulate

BATCH = 96
ITERS = 4
WORKERS = 3
TIMEOUT_S = 600.0


def run_loop(device=None) -> Tuple[List[Dict[str, Any]], float]:
    """Run the loop; returns (its history, one entry an iteration, and the
    wall in seconds).  Raises if it does not finish."""
    dev = env.device(device)
    with tempfile.TemporaryDirectory() as ws:
        rt = MerlinRuntime(workspace=ws,
                           hierarchy=HierarchyCfg(max_fanout=8, bundle=16))
        loop = OptimizationLoop(rt, jag_simulate, batch_per_iter=BATCH,
                                max_iters=ITERS, constraint_max=360.0,
                                seed=0, device=dev)
        t0 = time.time()
        with WorkerPool(rt, n_workers=WORKERS) as pool:
            loop.start()
            while len(loop.history) < loop.max_iters and \
                    time.time() - t0 < TIMEOUT_S:
                time.sleep(0.05)
            pool.drain(timeout=120)
        wall = time.time() - t0
    if len(loop.history) < ITERS:
        raise RuntimeError(f"{len(loop.history)} of {ITERS} iterations "
                           f"finished in {TIMEOUT_S} s")
    return loop.history, wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.optimization_loop")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    history, wall = run_loop(args.device)
    print("iter |    n | best yield")
    for h in history:
        print(f"{h['iter']:>4} | {h['n']:>4} | {h['best']:.3e}")
    gain = history[-1]["best"] / history[0]["best"]
    print(f"robust-yield improvement over random init: {gain:.2f}x "
          f"in {len(history)} iterations "
          f"({history[-1]['n']} total simulations)")
    print(json.dumps({"device": env.device_name(env.device(args.device)),
                      "history": history, "gain": gain, "wall_s": wall}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
