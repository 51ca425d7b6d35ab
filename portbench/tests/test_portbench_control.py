"""The control of ``correct``: the reference put in the program's place
and computed in the precision below the configuration's (float8 e4m3
operands for a bf16 compute dtype) must not pass; nor may the reference
with the scans' state dropped between chunks.

On the card (``-m cuda``, about 10 minutes a cell, on as many cards as
the cell asks for): at each cell's own size, on three seeds, the control
and the planted faults (``calibrate.readings``; a cell on several cards
through ``calibrate.py`` on its ranks) fail the cell's limits, the
dropped carry in the training cells (decode's ``logit_gap`` does not see
it at random weights).  On the CPU, at a small size: the control reads at
least three times what the program in bf16 reads on one of the numbers,
for each cell, and the dropped carry as much over the program in float32
in the training cells whose layers carry a state."""
import json
import subprocess
import sys

import pytest
import torch

from portbench import calibrate, layers
from portbench.lib import compare, manifest, runner
from portbench.reference import lm as ref_lm
from portbench.tests import tiny

CELLS = [w["name"] for w in manifest.load()["workloads"]]
# the CPU's tests run the staged cells too (``tiny.py``)
ALL = [w["name"] for w in tiny.with_staged()["workloads"]]
TRAIN = [c for c in ALL if tiny.full(c).traffic["kind"] == "train"]
MOE = [c for c in TRAIN
       if ref_lm.routed_layers(tiny.full(c).config["model"])]
CARRY = [c for c in TRAIN if any(
    getattr(layers.get(layers.split(e)[0]), "STATE", False)
    for e in ref_lm.plan(tiny.full(c).config["model"]))]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run with -m cuda on the card")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_at_the_cells_size(card, name):
    cell = manifest.cell(name)
    for seed in SEEDS:
        got = _readings(cell, seed, card)
        runner.log("readings", {"cell": name, "seed": seed, **got})
        assert compare.decide(got["program"], cell.limits)[0], got["program"]
        for what, numbers in got.items():
            if what.startswith("control") or (
                    what.startswith("fault") and (
                        what != "fault_carry" or name in TRAIN)):
                assert not compare.decide(numbers, cell.limits)[0], (what, numbers)


def _readings(cell, seed, card):
    """{reading: numbers} at the cell's own size: in this process, or for
    a cell on several cards by ``calibrate.py`` on its ranks."""
    if cell.entry["chips"] == 1:
        return calibrate.readings(cell, seed, 2.0, card)
    if torch.cuda.device_count() < cell.entry["chips"]:
        pytest.skip(f"{cell.name} needs {cell.entry['chips']} cards")
    out = subprocess.run([sys.executable, calibrate.__file__, "--workload",
                          cell.name, "--control-seeds", str(seed)],
                         capture_output=True, text=True, timeout=3600,
                         check=True)
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    return {ln["reading"]: ln["numbers"] for ln in lines}


def _least_ratio(cell, what):
    """The least over two seeds of the most, over the cell's compared
    numbers that ``what`` reads, that it reads over the program."""
    ratios = []
    for seed in (1, 2):
        got = calibrate.readings(cell, seed, 0.2, "cpu")
        prog = got["program"]
        ratios.append(max(got[what][k]["value"] / max(prog[k]["value"], 1e-9)
                          for k in cell.limits if k in got[what]))
    return min(ratios), ratios


@pytest.mark.parametrize("name", ALL)
def test_the_control_reads_well_above_the_program(name):
    least, ratios = _least_ratio(tiny.cell(name, compute="bfloat16"),
                                 "control_fp8")
    assert least >= 3.0, ratios


@pytest.mark.parametrize("name", CARRY)
def test_the_dropped_carry_reads_well_above_the_program(name):
    least, ratios = _least_ratio(tiny.cell(name), "fault_carry")
    assert least >= 3.0, ratios


@pytest.mark.parametrize("what", ["fault_no_aux", "fault_half_batch",
                                  "fault_routes"])
@pytest.mark.parametrize("name", MOE)
def test_the_moe_faults_read_well_above_the_program(name, what):
    """The aux losses left out, half the batch, and each token routed to
    its neighbour's experts, in a cell with MoE layers (one card's experts
    left out of the exchange needs ranks: ``test_portbench_ranks.py``)."""
    least, ratios = _least_ratio(tiny.cell(name), what)
    assert least >= 3.0, ratios
