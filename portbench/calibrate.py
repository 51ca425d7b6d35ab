"""Readings that the limits of ``correct`` are set from, at a cell's own
size, on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12 --control-seeds 21,22,23

For each seed of either list: one run of the cell (``--seconds`` of
window) and its numbers, the program's readings (the lower end of a
limit).  For each of ``--control-seeds`` besides: against the same
float32 reference, the control (the reference put in the program's place
and computed in the precision below the configuration's: float8 e4m3
operands for a bf16 compute dtype) and the faults a cell can have,
planted in the reference: where a layer carries a state between chunks,
that state dropped (``fault_carry``); in training, half of every batch
left out, the mean taken over the rest, and with MoE layers the aux
losses left out (``fault_no_aux``) and, on several cards, one rank's
experts left out of the exchange of partial sums (``fault_lost_share``);
in serving, one served token a checked row altered where it is produced.
In a model with MoE layers the control and the faults take the
program's recorded expert choices, as the reference does; and one fault
is planted in the program, a run of the cell whose router gives each
token its neighbour's top-k experts (``fault_routes``: the reference
takes those choices, so the share of them that its own top-k would not
make is what reads it).  A state left unchanged reads 1 by the training
numbers' measure and needs no run.  One JSON line each.  A cell on
several cards runs on as many ranks, as ``run.py`` runs it; rank 0
prints.  ``--plant routes`` runs the ``--seeds`` with that fault planted
(reading ``fault_routes``), where the other readings are not wanted.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import layers  # noqa: E402
from portbench.kinds import decode, train  # noqa: E402
from portbench.lib import compare, manifest, ranks, runner  # noqa: E402
from portbench.reference import lm as ref_lm  # noqa: E402

CONTROL = ref_lm.Precision("fp8")
NO_CARRY = ref_lm.Precision("float32", carry=False)
F32 = ref_lm.Precision("float32")


def say(**kw):
    print(json.dumps(kw), flush=True)


def train_faults(cell, group):
    """(reading, precision, the fault's keywords of ``train.reference``)
    of the control and of each fault the cell can have."""
    m = cell.config["model"]
    out = [("control_fp8", CONTROL, {})]
    if any(getattr(layers.get(layers.split(e)[0]), "STATE", False)
           for e in ref_lm.plan(m)):
        out.append(("fault_carry", NO_CARRY, {}))
    out.append(("fault_half_batch", F32,
                {"rows": slice(0, cell.traffic["rows"] // 2)}))
    if ref_lm.routed_layers(m):
        out.append(("fault_no_aux", F32, {"aux": False}))
        if group is not None:
            out.append(("fault_lost_share", F32, {"drop": group.world - 1}))
    return out


def train_readings(cell, seed, seconds, device, group=None) -> dict:
    """{reading: numbers} of a run of the cell (the program), the control
    and the faults, each against the run's own float32 reference; with
    MoE layers, a second run with the router's fault planted, against
    its own."""
    run = cell_run(cell, seed, seconds, device, group)
    got = {"program": run["numbers"]}
    ref, steps = run.pop("reference"), run.pop("routes")
    del run
    for name, prec, kw in train_faults(cell, group):
        got[name] = compare.train_numbers(
            train.reference(cell, seed, device, group, steps or None, prec,
                            **kw), ref)
    del ref, steps
    if ref_lm.routed_layers(cell.config["model"]):
        with neighbour_routes():
            got["fault_routes"] = cell_run(cell, seed, seconds, device,
                                           group)["numbers"]
    return got


@contextlib.contextmanager
def neighbour_routes():
    """The port's top-k planted wrong while the block runs: each token
    takes its neighbour's top-k experts (the previous token's of its
    routing group; the first token the last one's), with its own
    probabilities at them as gates."""
    from repro_torch.models import moe
    real = moe._top_k

    def top_k(probs, k):
        _, ids = real(probs.roll(1, dims=-2), k)
        return probs.gather(-1, ids), ids
    moe._top_k = top_k
    try:
        yield
    finally:
        moe._top_k = real


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


def readings(cell, seed, seconds, device, group=None) -> dict:
    if cell.traffic["kind"] == "train":
        return train_readings(cell, seed, seconds, device, group)
    return decode_readings(cell, seed, seconds, device)


def altered(served, cell):
    """One token a row, halfway along, replaced by the next id."""
    s = served.clone()
    k = s.shape[1] // 2
    s[:, k] = (s[:, k] + 1) % cell.config["model"]["vocab_size"]
    return s


def cell_run(cell, seed, seconds, device, group=None):
    kind = importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")
    if group is None:
        return kind.run(cell, seed, seconds, False, device, time.monotonic(),
                        runner.log)
    return kind.run(cell, seed, seconds, False, device, time.monotonic(),
                    runner.log if group.rank == 0 else runner.quiet,
                    group=group)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--plant", choices=["routes"], default=None)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    cell = manifest.cell(args.workload)
    chips = cell.entry["chips"]
    group, procs, device = None, [], "cuda:0"
    if chips > 1:
        if args.rank == 0:
            args.port = ranks.free_port()
            procs = ranks.start(__file__, sys.argv[1:], chips, args.port)
            ranks.supervise(procs, 3 * 3600)
        else:
            ranks.orphan_guard()
        group = ranks.join(args.rank, chips, args.port)
        device = group.device
    lead = args.rank == 0
    if lead:
        runner.log("card", torch.cuda.get_device_name(0))
    for s in filter(None, args.control_seeds.split(",")):
        got = readings(cell, int(s), args.seconds, device, group)
        for name, numbers in got.items():
            if lead:
                say(cell=cell.name, seed=int(s), reading=name, numbers=numbers)
    planted = neighbour_routes if args.plant else contextlib.nullcontext
    for s in filter(None, args.seeds.split(",")):
        with planted():
            out = cell_run(cell, int(s), args.seconds, device, group)
        if lead:
            say(cell=cell.name, seed=int(s),
                reading="fault_routes" if args.plant else "program",
                numbers=out["numbers"], peak=out["memory_peak_bytes"])
        del out
    if group is not None:
        group.barrier()
        ranks.leave()
        for p in procs:
            p.wait()


if __name__ == "__main__":
    main()
