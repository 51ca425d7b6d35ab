"""The Merlin quickstart on the port (after ``examples/quickstart.py``):

    python -m repro_torch.launch.quickstart [--device cpu] [--samples 512] \
        [--two-process | --sharded]

1. a study (simulate) over JAG ICF samples drawn from a seed;
2. run through ``MerlinRuntime`` and a ``WorkerPool`` of 4 workers (one
   root message enqueued; workers expand the task hierarchy), each bundle
   through the ``EnsembleExecutor`` (one CUDA graph a bucket on the card)
   into a ``Bundler``;
3. a deep-ensemble surrogate trained on half the bundled rows, scored by
   its R² on the other half.

The queue is in-process by default.  ``--two-process`` hosts it in one
``python -m repro_torch.launch.serve broker-serve`` process and runs the
study over ``tcp://`` (the paper's standalone broker host); ``--sharded``
hosts it on two broker-serve shard processes federated by queue hash
(``MerlinRuntime(broker=[url0, url1])``, a ``ShardedBroker``).  The broker
processes are stopped when the study ends, whatever its result.

Runs on the card unless ``--device cpu`` is given, and raises when no card
is visible.  Prints one JSON line: bundles, simulations, ``sim_time``,
graph captures and the surrogate's R².
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, Iterator, Tuple

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


# the port's source tree, for the broker processes' PYTHONPATH
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn_broker_server(workspace: str, name: str = "broker",
                        extra_args: "list[str]" = ()) \
        -> "tuple[subprocess.Popen, str]":
    """Start a broker-serve process; return (proc, tcp:// URL)."""
    port_file = os.path.join(workspace, f"{name}.port")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "broker-serve",
         "--port", "0", "--port-file", port_file, *extra_args],
        env={**os.environ,
             "PYTHONPATH": _SRC + os.pathsep + os.environ.get("PYTHONPATH", "")})
    deadline = time.monotonic() + 30
    while not os.path.exists(port_file):
        if proc.poll() is not None:
            raise RuntimeError("broker server died during startup")
        if time.monotonic() > deadline:
            proc.terminate()
            raise RuntimeError("broker server did not come up in 30s")
        time.sleep(0.05)
    with open(port_file) as f:
        port = int(f.read())
    return proc, f"tcp://127.0.0.1:{port}"


@contextlib.contextmanager
def broker_processes(mode: str, workspace: str) -> Iterator[Any]:
    """The ``broker`` argument of ``MerlinRuntime`` for one of the three
    deployments: ``"mem"`` (in-process; None), ``"tcp"`` (one broker-serve
    process; its URL) or ``"sharded"`` (two broker-serve shards; their URL
    list).  Raises if a server dies during startup, and stops every server
    on exit."""
    if mode not in ("mem", "tcp", "sharded"):
        raise ValueError(f"unknown broker mode {mode!r}")
    procs = []
    try:
        if mode == "tcp":
            proc, url = spawn_broker_server(workspace)
            procs.append(proc)
            yield url
        elif mode == "sharded":
            urls = []
            for i in range(2):
                proc, url = spawn_broker_server(
                    workspace, name=f"shard{i}",
                    extra_args=["--shard-of", f"{i}/2"])
                procs.append(proc)
                urls.append(url)
            yield urls
        else:
            yield None
    finally:
        for proc in procs:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)


def run_study(device=None, samples: int = 512, broker_mode: str = "mem"
              ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray], Surrogate]:
    """Run the quickstart study over the ``broker_mode`` deployment (see
    ``broker_processes``); returns (summary, the bundled archive as
    ``Bundler.load_all`` gives it, the trained surrogate)."""
    dev = env.device(device)
    with tempfile.TemporaryDirectory() as ws, \
            broker_processes(broker_mode, ws) as broker:
        rt = MerlinRuntime(broker=broker, workspace=ws,
                           hierarchy=HierarchyCfg(max_fanout=8, bundle=BUNDLE))
        routing = ({q: rt.broker.shard_for(q)
                    for q in (rt.real_queue, rt.gen_queue)}
                   if broker_mode == "sharded" else None)
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
        close = getattr(rt.broker, "close", None)
        if close is not None:
            close()

    X, y = regression_dataset(data, target="yield")
    n = len(X)
    t1 = time.monotonic()
    sur = train_surrogate(X[: n // 2], y[: n // 2], steps=STEPS, device=dev)
    mu, _ = sur.predict(X[n // 2:])
    train_s = time.monotonic() - t1
    summary = {
        "device": env.device_name(dev),
        "broker": type(rt.broker).__name__, "routing": routing,
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
    ap.add_argument("--two-process", action="store_true",
                    help="host the queue in a separate broker-serve process "
                         "(no shared filesystem for the queue)")
    ap.add_argument("--sharded", action="store_true",
                    help="host the queues on TWO broker-serve shard "
                         "processes, federated client-side by queue hash")
    args = ap.parse_args(argv)
    mode = ("sharded" if args.sharded else
            "tcp" if args.two_process else "mem")
    summary, _, _ = run_study(args.device, samples=args.samples,
                              broker_mode=mode)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
