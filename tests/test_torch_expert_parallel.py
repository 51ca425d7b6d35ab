"""Expert parallelism over ``model`` (ROADMAP Queue C 1): the MoE layer
keeps its experts split over ``model`` under a mesh, runs each rank's
E / m experts on its slice of the slot table, and reduces the combine's
partial sums on the (rows, D) activations.

deepseek-v2-lite-16b (reduced, float32: 8 experts, top 2, a dense
prologue layer and two MoE layers) takes two training steps on gloo ranks
at the ("data", "model") meshes (1, 2), (1, 4) and (2, 2), with the
``gshard`` and the ``sort`` dispatch, from the same seeded state as an
unsharded run on one rank: the losses, gradient norms, the eval step's
loss and aux losses before each step, and every stepped parameter agree
within rel 1e-5 (the tensor-parallel tolerance: float32 sums in another
order, AdamW at eps 1e-3, see ``_torch_dist.step_optimizer``).  During
the mesh steps no expert weight is all-gathered over ``model``: the
tensors DTensor gathers over that mesh dim are recorded, and none has an
expert weight's shape.
"""
import json

import numpy as np
import pytest

import _torch_dist
from repro_torch.configs import registry as preg

REL = 1e-5
ARCH = "deepseek-v2-lite-16b"
CASES = [("gshard", ARCH, {"moe_group": 12}),
         ("sort", ARCH, {"moe_group": 12, "moe_impl": "sort"})]
MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
RUNS = [(label, f"{a}x{b}") for label, _, _ in CASES
        for world in MESHES for a, b in MESHES[world]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for world, shapes in MESHES.items():
        tmp = tmp_path_factory.mktemp(f"expert_parallel_{world}")
        _torch_dist.spawn(_torch_dist.tensor_parallel_rank, world, str(tmp),
                          420, CASES, shapes, 2, 8, 12)
        res = json.loads((tmp / "tp.json").read_text())
        for label, _, _ in CASES:
            for a, b in shapes:
                out[(label, f"{a}x{b}")] = (tmp, res[label])
    return out


@pytest.mark.parametrize("label,mesh", RUNS)
def test_expert_parallel_steps_equal_the_unsharded_steps(runs, label, mesh):
    tmp, res = runs[(label, mesh)]
    names = ("loss", "grad_norm", "eval_loss", "moe_lb_loss", "moe_z_loss")
    for got, want in zip(res[mesh], res["plain"]):
        for name, g, w in zip(names, got, want):
            assert abs(g - w) <= REL * abs(w), (name, g, w)
    want = np.load(tmp / f"{label}_plain.npz")
    got = np.load(tmp / f"{label}_{mesh}.npz")
    assert set(got.files) == set(want.files)
    assert any("experts" in k for k in want.files)
    for k in want.files:
        rel = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]),
                                                     1e-12)
        assert rel < REL, (k, rel)


@pytest.mark.parametrize("label,mesh", RUNS)
def test_no_expert_weight_is_gathered_over_model(runs, label, mesh):
    _, res = runs[(label, mesh)]
    cfg = preg.reduced_config(ARCH)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    gathered = {tuple(s) for s in res[f"gathered/{mesh}"]}
    assert not gathered & {(E, d, f), (E, f, d)}, sorted(gathered)
