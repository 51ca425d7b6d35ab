"""A cell on several cards, at a size the CPU holds: the DeepSeek cell's
layers (a dense ``mla+glu`` layer, then ``mla+moe``) run through the
multi-process path on two gloo ranks, a (data 1, model 2) mesh, the
experts split over ``model`` in the program and in the reference.  The
harness's look for a card is skipped (each rank calls ``runner.run_cell``
in a process of its own); everything else is the run's own code.  A sound
run is correct; so is it not with the timed path broken underneath: a
step that hands its state back unchanged, half of the batch left out,
one rank's experts' partial sums left out of the exchange, and a router
that gives each token its neighbour's experts (the reference takes the
program's choices, so only the share of them its own top-k would not
make reads it)."""
import contextlib
import json
import multiprocessing as mp
import os
import time

import pytest

NAME = "deepseek-v2-lite-16b.train-ep4"
SEED = 2 ** 31 + 7
WORLD = 2


def _plant(how, rank):
    """Break the program's timed path in this rank's process, for as long
    as the context it returns is open."""
    import torch
    from repro_torch.models import moe
    from repro_torch.train import trainstep
    if how == "routes":
        from portbench import calibrate
        return calibrate.neighbour_routes()
    if how == "exchange":
        real = moe._dispatch

        def dispatch(*args, **kw):
            out = real(*args, **kw)
            return out if rank == 0 else torch.zeros_like(out)
        moe._dispatch = dispatch
        return contextlib.nullcontext()
    real_make = trainstep.make_train_step

    def make(cfg, optimizer=None, mesh=None, rules=None):
        real_step = real_make(cfg, optimizer, mesh, rules)

        def step(state, batch):
            if how == "half_batch":
                return real_step(state, {k: v[:v.shape[0] // 2]
                                         for k, v in batch.items()})
            before = {k: p.detach().clone()
                      for k, p in state.params.named_parameters()}
            _, met = real_step(state, batch)
            with torch.no_grad():
                for k, p in state.params.named_parameters():
                    p.copy_(before[k])
            return state, met
        return step
    trainstep.make_train_step = make
    return contextlib.nullcontext()


def _rank(rank, port, out, how):
    import torch
    torch.set_num_threads(1)
    from portbench.lib import ranks, runner
    from portbench.tests import tiny
    group = ranks.join(rank, WORLD, port, "cpu")
    try:
        cell = tiny.cell(NAME)
        cell.traffic["mesh"] = {"data": 1, "model": WORLD}
        with _plant(how, rank) if how else contextlib.nullcontext():
            r = runner.run_cell(NAME, SEED, 0.2, False, "cpu",
                                time.monotonic(), cell=cell, group=group)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(r, f)
    finally:
        ranks.leave()


def run(tmp_path, how=None):
    from portbench.lib import ranks
    ctx = mp.get_context("spawn")
    out = str(tmp_path / "result.json")
    port = ranks.free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, out, how))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    with open(out) as f:
        return json.load(f)


def test_a_sound_run_on_two_ranks_is_correct(tmp_path):
    r = run(tmp_path)
    assert r["correct"], r["checks"]
    assert all(n["value"] < 1e-4 for n in r["checks"].values()), r["checks"]
    assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert r["device"]["count"] == 4  # the cell's own, not the test's


@pytest.mark.parametrize("how", ["unchanged", "half_batch", "exchange",
                                 "routes"])
def test_a_broken_step_on_two_ranks_is_not_correct(tmp_path, how):
    r = run(tmp_path, how)
    assert not r["correct"], r["checks"]
    if how == "routes":  # the choices are the program's own, on both sides
        assert r["checks"]["route_flip_share"]["value"] > 0.3, r["checks"]
        assert r["checks"]["loss_gap"]["value"] < 1e-4, r["checks"]


def test_a_failed_rank_ends_the_run(tmp_path):
    """``supervise`` ends this process's run once another rank fails; run
    here in a child so that the test's process lives on."""
    import subprocess
    import sys
    code = ("import subprocess, sys, time\n"
            "from portbench.lib import ranks\n"
            "p = [subprocess.Popen([sys.executable, '-c', 'import sys; sys.exit(5)'])]\n"
            "ranks.supervise(p, 60, poll_s=0.05)\n"
            "time.sleep(30)\n"
            "print('result')\n")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                             [str(p) for p in sys.path if p])))
    assert out.returncode == 1 and "result" not in out.stdout
    assert "exited [(1, 5)]" in out.stderr
    assert time.monotonic() - t0 < 20
