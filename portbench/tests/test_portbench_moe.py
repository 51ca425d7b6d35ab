"""The reference's mixture of experts at a small size on the CPU: the
experts' shares add up to the whole layer, the routes replay to the same
loss, and the aux terms a layer leaves reach the gradients through a
remat recompute."""
import math

import pytest
import torch
import torch.distributed as dist

from portbench import layers
from portbench.lib import weights
from portbench.reference import lm, moe
from portbench.reference import train as ref_train
from portbench.tests import tiny

NAME = "deepseek-v2-lite-16b.train-ep4"
F32 = lm.Precision("float32")


@pytest.fixture
def cell():
    return tiny.cell(NAME)


def _params(cell, seed=3):
    m = cell.config["model"]
    return weights.draw_all(lm.param_shapes(m), cell.config["init"], seed,
                            "cpu")


def test_the_experts_shares_add_up_to_the_whole_layer(cell, tmp_path):
    """Each of 4 shares (its experts' part of the routed sum, beside the
    shared experts every share computes alike, counted once) adds up to
    the uncut layer's output, on a one-process group (the exchange then
    adds nothing: each share is seen alone)."""
    m = cell.config["model"]
    p = _params(cell)
    i = lm.routed_layers(m)[0]
    pre = f"layers.{i}."
    mlp = layers.mlp(layers.split(lm.plan(m)[i])[1])
    h = torch.randn(1, cell.traffic["seq_len"], m["d_model"],
                    generator=torch.Generator().manual_seed(0))

    def out(params, split):
        row = moe.Routing(m, 1, split=split).row(0, 1, record=True)
        return mlp.forward(params, pre, h, m, F32, row, i)
    whole = out(p, moe.Split())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        world, parts = 4, []
        for r in range(world):
            split = moe.Split(r, world, dist.group.WORLD)
            mine = {k: split.local(v) if k in lm.expert_leaves(m) else v
                    for k, v in p.items()}
            shared = out(mine, moe.Split(r, world, dist.group.WORLD, drop=r))
            parts.append(out(mine, split) - shared)
    finally:
        dist.destroy_process_group()
    assert all(float(x.abs().max()) > 0 for x in parts)
    torch.testing.assert_close(sum(parts) + shared, whole, rtol=1e-5,
                               atol=1e-6)


def test_the_recorded_routes_replay_to_the_same_loss(cell):
    """A step on the reference's own top-k, and the same step on those
    choices recorded and handed back, give the same loss and gradients;
    no choice reads as flipped."""
    m, o, t = cell.config["model"], cell.config["optimizer"], cell.traffic
    p0 = _params(cell)
    batch = weights.train_batch("cpu", 5, 0, t["rows"], t["seq_len"],
                                m["vocab_size"])
    own = ref_train.follow(p0, [batch], m, o, F32, moe=moe.Routing(m, 2))
    p = {k: v.clone() for k, v in p0.items()}
    routes = ref_train.own_routes(p, batch["tokens"], m, F32,
                                  moe.Routing(m, 2))
    book = moe.Routing(m, 2, [routes])
    replay = ref_train.follow(p0, [batch], m, o, F32, moe=book)
    assert replay["loss"] == own["loss"]
    assert replay["grad_leaf"] == own["grad_leaf"]
    assert book.stats["flips"] == 0 and book.stats["slots"] > 0
    assert 0 < book.stats["dropped"] < book.stats["slots"]


def test_the_aux_terms_reach_the_gradients_through_a_recompute(cell):
    m, t = cell.config["model"], cell.traffic
    batch = weights.train_batch("cpu", 7, 0, 2, t["seq_len"], m["vocab_size"])
    p0 = _params(cell)
    routes = ref_train.own_routes(p0, batch["tokens"], m, F32,
                                  moe.Routing(m, 1))
    got = []
    for remat in (False, True):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        book = moe.Routing(m, 1, [routes])
        book.use(0, routes)
        row = book.row(0, 2)
        loss = lm.loss(p, batch["tokens"][:1], batch["labels"][:1], m, F32,
                       remat=remat, moe=row)
        loss.backward()
        assert float(row.total().detach()) > 0
        got.append((float(loss), {k: v.grad for k, v in p.items()}))
    assert got[0][0] == pytest.approx(got[1][0], rel=1e-6)
    router = f"layers.{lm.routed_layers(m)[0]}.mlp.w_router"
    for k in got[0][1]:
        torch.testing.assert_close(got[1][1][k], got[0][1][k], rtol=1e-5,
                                   atol=1e-7)
    assert float(got[1][1][router].norm()) > 0
    assert math.isfinite(got[1][0])
