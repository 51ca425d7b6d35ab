"""A run of each cell, at a size the CPU holds, with the program's timed
path broken underneath: ``correct`` must come out false.  The harness's
look for a card is skipped (``runner.run_cell`` on the CPU); everything
else is the run's own code.  The faults are those each cell can have: a
training step that hands its state back unchanged, a step that leaves
half of the batch out and takes the mean over the rest, a served token
altered where it is produced.  The same runs unbroken are correct."""
import time

import pytest
import torch

from portbench.lib import runner
from portbench.tests import tiny

TRAIN = ["zamba2-1.2b.train-4k", "rwkv6-3b.train-4k"]
SEED = 2 ** 31 + 11


def run(name):
    return runner.run_cell(name, SEED, 0.2, False, "cpu", time.monotonic(),
                           cell=tiny.cell(name))


@pytest.mark.parametrize("name", TRAIN + ["zamba2-1.2b.decode-b128"])
def test_sound_runs_are_correct(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert all(n["value"] < 1e-4 for n in r["checks"].values()), r["checks"]


def _broken_step(monkeypatch, how):
    from repro_torch.train import trainstep
    real_make = trainstep.make_train_step

    def make(cfg, optimizer=None, mesh=None, rules=None):
        real = real_make(cfg, optimizer, mesh, rules)

        def step(state, batch):
            if how == "half_batch":
                return real(state, {k: v[:v.shape[0] // 2]
                                    for k, v in batch.items()})
            before = {k: p.detach().clone()
                      for k, p in state.params.named_parameters()}
            _, met = real(state, batch)
            with torch.no_grad():
                for k, p in state.params.named_parameters():
                    p.copy_(before[k])
            return state, met
        return step
    monkeypatch.setattr(trainstep, "make_train_step", make)


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("how", ["unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(monkeypatch, name, how):
    _broken_step(monkeypatch, how)
    r = run(name)
    assert not r["correct"], r["checks"]
    if how == "unchanged":
        assert r["checks"]["change_leaf_gap"]["value"] == pytest.approx(1.0)


def test_an_altered_served_token_is_not_correct(monkeypatch):
    from repro_torch.serve import engine
    real_make = engine.make_decode_fn

    def make(cfg, mesh=None, rules=None):
        real, calls = real_make(cfg, mesh, rules), [0]

        def decode(params, token, caches):
            logits, caches = real(params, token, caches)
            calls[0] += 1
            return (-logits if calls[0] == 2 else logits), caches
        return decode
    monkeypatch.setattr(engine, "make_decode_fn", make)
    r = run("zamba2-1.2b.decode-b128")
    assert not r["correct"], r["checks"]
