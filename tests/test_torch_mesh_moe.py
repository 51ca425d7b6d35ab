"""MoE layers train under a mesh (ROADMAP Queue C 1): deepseek-v2-lite-16b
and arctic-480b (reduced, float32) take two training steps on a (2, 2)
mesh of gloo ranks equal to the unsharded steps: the losses, gradient
norms, the eval step's loss, ``moe_lb_loss`` and ``moe_z_loss`` before
each step, and every stepped parameter within rel 1e-5.

The router runs on each rank's rows, in groups of ``moe_group`` tokens
chosen from the global token count.  With a group of 12 tokens each rank
holds whole groups of its rows (a microbatch's 2 rows x 12 tokens: 2
groups of the 4; the eval step's 4 rows: 4 of the 8) and routes them
alone; with the configs' group of 1024 one
group spans the microbatch's 48 tokens, more than a rank holds, so the
rows are gathered and every rank routes the one group.  The load-balance
loss is E * sum(me * ce) of global means in both, the means reduced over
the batch split before the product.
"""
import json

import numpy as np
import pytest

import _torch_dist

REL = 1e-5
CASES = [("deepseek_local", "deepseek-v2-lite-16b", {"moe_group": 12}),
         ("deepseek_gathered", "deepseek-v2-lite-16b", {}),
         ("arctic_local", "arctic-480b", {"moe_group": 12}),
         ("arctic_gathered", "arctic-480b", {})]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_moe")
    _torch_dist.spawn(_torch_dist.tensor_parallel_rank, 4, str(tmp), 420,
                      CASES, [(2, 2)], 2, 8, 12)
    return tmp, json.loads((tmp / "tp.json").read_text())


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_moe_steps_equal_the_unsharded_steps(runs, label):
    tmp, out = runs
    res = out[label]
    names = ("loss", "grad_norm", "eval_loss", "moe_lb_loss", "moe_z_loss")
    for got, want in zip(res["2x2"], res["plain"]):
        for name, g, w in zip(names, got, want):
            assert abs(g - w) <= REL * abs(w), (name, g, w)
        assert want[3] > 0 and want[4] > 0  # the aux losses are there
    want = np.load(tmp / f"{label}_plain.npz")
    got = np.load(tmp / f"{label}_2x2.npz")
    assert set(got.files) == set(want.files)
    assert any("experts" in k for k in want.files)
    for k in want.files:
        rel = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]),
                                                     1e-12)
        assert rel < REL, (k, rel)


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_ranks_route_whole_groups(runs, label):
    _, out = runs
    groups = out[label]["heads/2x2"]["moe_groups"]
    assert groups
    for here, total in groups:
        if label.endswith("_local"):  # 2 data ranks, half the groups each
            assert total in (4, 8) and here * 2 == total, (here, total)
        else:  # one group over the microbatch, gathered to every rank
            assert (here, total) == (1, 1)
