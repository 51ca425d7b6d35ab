"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number that
decides ``correct`` beside its limit); the same numbers are the last lines
of standard error.  Without a card, or with fewer than the cell asks for,
or with JAX or the JAX package loaded once the run is over, it prints no
result and exits non-zero.

A cell on several cards runs one process a card (``lib/ranks.py``): this
one is rank 0 and starts the others, the same command with ``--rank`` and
``--port``.  Every rank checks what it loaded; rank 0 prints the result
once every rank has ended well, and none if one did not.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 1150  # a run on several cards, its first build included
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda_cache"}


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def loaded() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & FORBIDDEN)


def on_ranks(args, argv, chips):
    """(result, exit code) of this process's rank of a cell on ``chips``
    cards: rank 0 starts the others and has the result once all have
    ended well; a rank that loaded JAX or the JAX package, or rank 0 where
    any did, exits 3 with none."""
    from portbench.lib import ranks, runner
    procs = []
    if args.rank == 0:
        runner.log("card", card_line())
        args.port = ranks.free_port()
        procs = ranks.start(__file__, argv, chips, args.port)
        ranks.supervise(procs, LIMIT_S)
    else:
        ranks.orphan_guard()
    try:
        group = ranks.join(args.rank, chips, args.port)
        result = runner.run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), group.device, T_START,
                                 group=group)
        found = group.gather(loaded())
        group.barrier()
        ranks.leave()
    except Exception:
        # the traceback first: stopping the ranks may end this process
        traceback.print_exc()
        sys.stderr.flush()
        ranks.stop(procs)
        return None, 1
    if args.rank != 0:
        return None, 3 if loaded() else 0
    codes = [p.wait() for p in procs]
    bad = {r: f for r, f in enumerate(found) if f}
    if bad:
        print(f"portbench: the run loaded {bad} (by rank)", file=sys.stderr)
        return None, 3
    if any(codes):
        print(f"portbench: ranks exited {codes}", file=sys.stderr)
        return None, 1
    return result, 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from portbench.lib import manifest, runner

    cell = manifest.cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    if chips == 1:
        runner.log("card", card_line())
        result = runner.run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), "cuda:0", T_START)
        found = loaded()
        if found:
            print(f"portbench: the run loaded {found}", file=sys.stderr)
            return 3
    else:
        result, code = on_ranks(
            args, argv if argv is not None else sys.argv[1:], chips)
        if result is None:
            return code
    for name, n in result["checks"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
