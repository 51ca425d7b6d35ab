"""Readings that the limits of ``correct`` are set from, at a cell's own
size, on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12 --control-seeds 21,22,23

For each seed of either list: one run of the cell (``--seconds`` of
window) and its numbers, the program's readings (the lower end of a
limit).  For each of ``--control-seeds`` besides: against the same
float32 reference, the control (the reference put in the program's place
and computed in the precision below the configuration's: float8 e4m3
operands for a bf16 compute dtype) and the faults a cell can have,
planted in the reference: the scans' state dropped between chunks
(``fault_carry``); in training, half of every batch left out, the mean
taken over the rest; in serving, one served token a checked row altered
where it is produced.  A state left unchanged reads 1 by the training
numbers' measure and needs no run.  One JSON line each.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench.kinds import decode  # noqa: E402
from portbench.lib import compare, manifest, runner, weights  # noqa: E402
from portbench.reference import lm as ref_lm  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402

CONTROL = ref_lm.Precision("fp8")
NO_CARRY = ref_lm.Precision("float32", carry=False)


def say(**kw):
    print(json.dumps(kw), flush=True)


def train_readings(cell, seed, seconds, device) -> dict:
    """{reading: numbers} of a run of the cell (the program), the control
    and the faults, each against the run's own float32 reference."""
    m, o, t = cell.config["model"], cell.config["optimizer"], cell.traffic
    run = cell_run(cell, seed, seconds, device)
    got = {"program": run["numbers"]}
    ref = run.pop("reference")
    del run
    p0 = weights.draw_all(ref_lm.param_shapes(m), cell.config["init"], seed,
                          device)
    batches = [weights.train_batch(device, seed, i, t["rows"], t["seq_len"],
                                   m["vocab_size"])
               for i in range(t["warm_steps"])]
    for name, prec, rows in (
            ("control_fp8", CONTROL, None),
            ("fault_carry", NO_CARRY, None),
            ("fault_half_batch", ref_lm.Precision("float32"),
             slice(0, t["rows"] // 2))):
        got[name] = compare.train_numbers(
            ref_train.follow(p0, batches, m, o, prec, rows), ref)
    return got


def decode_readings(cell, seed, seconds, device) -> dict:
    """{reading: numbers} of a run of the cell (the program), the control
    and the dropped carry at each position of the same prompts and served
    tokens, and a served token altered where it is produced."""
    run = cell_run(cell, seed, seconds, device)
    got = {"program": run["numbers"]}
    for name, prec, served in (
            ("control_fp8", CONTROL, run["served"]),
            ("fault_carry", NO_CARRY, run["served"]),
            ("fault_token", ref_lm.Precision("float32"),
             altered(run["served"], cell))):
        gap = decode.served_gap(cell.config, seed, run["prompts"], served,
                                cell.traffic["checked_rows"], prec, device)
        got[name] = {"logit_gap": {"value": gap}}
    return got


def readings(cell, seed, seconds, device) -> dict:
    if cell.traffic["kind"] == "train":
        return train_readings(cell, seed, seconds, device)
    return decode_readings(cell, seed, seconds, device)


def altered(served, cell):
    """One token a row, halfway along, replaced by the next id."""
    s = served.clone()
    k = s.shape[1] // 2
    s[:, k] = (s[:, k] + 1) % cell.config["model"]["vocab_size"]
    return s


def cell_run(cell, seed, seconds, device):
    kind = importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")
    return kind.run(cell, seed, seconds, False, device, time.monotonic(),
                    runner.log)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    cell = manifest.cell(args.workload)
    device = "cuda:0"
    runner.log("card", torch.cuda.get_device_name(0))
    for s in filter(None, args.control_seeds.split(",")):
        for name, got in readings(cell, int(s), args.seconds, device).items():
            say(cell=cell.name, seed=int(s), reading=name, numbers=got)
    for s in filter(None, args.seeds.split(",")):
        out = cell_run(cell, int(s), args.seconds, device)
        say(cell=cell.name, seed=int(s), reading="program",
            numbers=out["numbers"], peak=out["memory_peak_bytes"])
        del out


if __name__ == "__main__":
    main()
