"""Training traffic: rows of uniform tokens through the port's training
step, as ``Trainer`` builds it (``make_optimizer`` of the config's
optimizer, ``make_train_step``), without checkpoint saves.

Set-up builds one state (the model with the seed's weights and fresh
AdamW state) and drives it through ``warm_steps`` steps of the window's
own call and feed, which the reference follows.  The same state then runs
the window.  Every step has rows of its own (``weights.train_batch``).

On several cards (a ``group``) the traffic's ``mesh`` ({"data", "model"})
is built by the port's ``launch/mesh.py:make_host_mesh``, the step is the
port's ``make_train_step(cfg, optimizer, mesh=, rules=)`` with the arch's
rules, and the state is placed as ``Trainer`` places it
(``program.placed_state``); every rank takes the same rows.  While the
warm steps run, the MoE layers' expert choices are recorded
(``lib/routes.py``) and rank 0's are what every rank's reference takes;
the numbers that decide ``correct`` then include the choices themselves
(``route_numbers``).

Traffic keys: ``rows`` and ``seq_len`` a step, ``warm_steps``,
``trace_steps`` (steps under the profiler with ``--trace 1``), and on
several cards ``mesh``.
"""
from __future__ import annotations

import contextlib
import gc
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist

from portbench import layers
from portbench.lib import (compare, counters, program, routes, trace,
                           weights, window, work)
from portbench.reference import lm as ref_lm
from portbench.reference import moe as ref_moe
from portbench.reference import train as ref_train


def launch_shapes(config: dict, cfg, traffic: dict, mesh: dict):
    """({kernel: {kind: the shape of its launches in a step}}, {kernel:
    {kind: (share of the forward launches, of the backward calls)}}) for
    each layer kind's hand-written kernel: one launch a layer and
    microbatch over the rank's rows and heads (``mesh``: {"data",
    "model"})."""
    m, S = config["model"], traffic["seq_len"]
    b = traffic["rows"] // max(1, cfg.microbatch) // mesh["data"]
    by_kind = expected_launches(cfg, by_kind=True)
    shapes, shares = {}, {}
    for name, kinds in by_kind.items():
        if name.endswith("_bwd"):
            continue
        bwd = by_kind[name + "_bwd"]
        f, g = sum(kinds.values()), sum(bwd.values())
        for kind in kinds:
            k = layers.get(kind).KERNEL
            shapes.setdefault(name, {})[kind] = k.launch_shape(
                m, b, S, tp=mesh["model"])
            shares.setdefault(name, {})[kind] = (kinds[kind] / f,
                                                 bwd[kind] / g)
    return shapes, shares


def expected_launches(cfg, by_kind=False) -> dict:
    """Kernel calls a step: a layer's forward once a microbatch in the
    prologue and twice under remat full (the recompute), its backward
    once ({kernel: calls}, or {kernel: {kind: calls}})."""
    n_mb, n_pro = max(1, cfg.microbatch), len(cfg.prologue)
    twice = 1 if cfg.remat == "none" else 2
    out = {}
    for i, spec in enumerate(cfg.plan):
        k = layers.get(spec.kind).KERNEL
        if k:
            fwd = 1 if i < n_pro else twice
            for name, n in ((k.name, fwd * n_mb), (k.name + "_bwd", n_mb)):
                kinds = out.setdefault(name, {})
                kinds[spec.kind] = kinds.get(spec.kind, 0) + n
    return out if by_kind else {k: sum(v.values()) for k, v in out.items()}


def _routed(cfg, m):
    """(MoE layers, those of them a remat recompute runs again)."""
    moe = ref_lm.routed_layers(m)
    again = [] if cfg.remat == "none" else \
        [i for i in moe if i >= len(cfg.prologue)]
    return len(moe), len(again)


def _shared_routes(steps, group):
    """Rank 0's recorded routes on every rank, and the most ids a rank
    recorded otherwise."""
    if group is None:
        return steps, 0
    differ = 0
    for step in steps:
        for mb in step:
            for j, t in enumerate(mb):
                mb[j] = t.clone()
                dist.broadcast(mb[j], 0)
                differ += int((mb[j] != t).sum())
    return steps, group.max(differ)


def route_numbers(stats: dict, recompute_differs: int,
                  ranks_differ: int) -> dict:
    """The numbers of the expert choices the reference took from the
    program: the share of (token, slot) choices that the reference's own
    top-k would not make (a program that chose its experts wrongly reads
    high here alone, since the reference takes its choices), and the ids
    that a remat recompute, or a rank other than 0, chose otherwise than
    the forward and rank 0 (0 in a sound run: an exact comparison).
    ``stats``: the reference's ``Routing.stats``."""
    return {"route_flip_share": {"value": stats["flips"] / stats["slots"]},
            "route_recompute_differs": {"value": recompute_differs},
            "route_ranks_differ": {"value": ranks_differ}}


def reference(cell, seed: int, device, group, steps, prec, rows=None,
              drop=None, aux=True) -> dict:
    """The plain reference's ``follow`` of the cell's warm steps from the
    seed's weights, on ``steps`` (the program's recorded routes, where
    the model has MoE layers); ``rows``, ``drop`` and ``aux`` plant the
    faults ``calibrate.py`` reads (half the batch; rank ``drop``'s
    experts left out of the combine; the aux losses left out).  Every
    rank holds its share of the experts."""
    m, o, t = cell.config["model"], cell.config["optimizer"], cell.traffic
    cfg = program.port_config(cell.config)
    ref_lm.pin_float32()
    moe, part = None, None
    if ref_lm.routed_layers(m):
        split = ref_moe.Split() if group is None else ref_moe.Split(
            group.rank, group.world, drop=drop)
        moe = ref_moe.Routing(m, max(1, cfg.microbatch), steps, split, aux)
        experts = ref_lm.expert_leaves(m)
        part = lambda k, v: split.local(v) if k in experts else v  # noqa: E731
    p0 = weights.draw_all(ref_lm.param_shapes(m), cell.config["init"], seed,
                          device, part=part)
    batches = [weights.train_batch(device, seed, i, t["rows"], t["seq_len"],
                                   m["vocab_size"])
               for i in range(t["warm_steps"])]
    return ref_train.follow(p0, batches, m, o, prec, rows, moe)


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        log, group=None) -> dict:
    config, traffic = cell.config, cell.traffic
    m, o = config["model"], config["optimizer"]
    rows, S, V = traffic["rows"], traffic["seq_len"], m["vocab_size"]
    warm = traffic["warm_steps"]
    cfg = program.port_config(config)
    from repro_torch.train import optimizer as popt
    from repro_torch.train import trainstep

    optimizer = popt.make_optimizer(
        o["name"], lr=o["lr"], cfg=cfg, b1=o["b1"], b2=o["b2"], eps=o["eps"],
        wd=o["wd"], clip_norm=o["clip_norm"])
    shape = {"data": 1, "model": 1} if group is None else traffic["mesh"]
    if group is None:
        step_fn = trainstep.make_train_step(cfg, optimizer)
        model = program.port_model(cfg, config, seed, device)
        placed = (model, optimizer.init(trainstep.named_params(model)))
    else:
        from repro_torch.configs import registry
        from repro_torch.launch import mesh as pmesh
        mesh = pmesh.make_host_mesh(shape["data"], shape["model"],
                                    device_type=torch.device(device).type)
        rules = registry.arch_rules(config["port"]["arch"])
        step_fn = trainstep.make_train_step(cfg, optimizer, mesh=mesh,
                                            rules=rules)
        placed = program.placed_state(cfg, config, seed, device, optimizer,
                                      mesh, rules)
    # the state lives in ``state`` alone: a step's update replaces it
    state = [trainstep.TrainState(
        *placed, torch.zeros((), dtype=torch.int32, device=device))]
    model = placed[0]
    del placed
    done = [0]

    def feed(i):
        return weights.train_batch(device, seed, i, rows, S, V)

    def one():
        """One step of the window's call and feed; returns its metrics
        once its loss is on the host."""
        state[0], met = step_fn(state[0], feed(done[0]))
        met = dict(met, loss=float(met["loss"]))
        done[0] += 1
        return met

    n_moe, n_again = _routed(cfg, m)
    calls, steps, again = [], [], 0
    prog = {"loss": []}
    book = 0.0  # the checks' bookkeeping inside set-up, not set-up
    for i in range(warm):
        with routes.recorded(calls) if n_moe else contextlib.nullcontext():
            met = one()
        t0 = time.monotonic()
        prog["loss"].append(met["loss"])
        if i == 0:
            prog["grad_norm"] = float(met["grad_norm"])
            prog["grad_leaf"] = {
                k: float(torch.linalg.vector_norm(program.whole(v))) / (1 - o["b1"])
                for k, v in state[0].opt["m"].items()}
        if n_moe:
            ids, differ = routes.by_microbatch(calls, max(1, cfg.microbatch),
                                               n_moe, n_again)
            steps.append(ids)
            again += differ
            calls.clear()
        book += time.monotonic() - t0
    t0 = time.monotonic()
    prog["change_leaf"] = program.parameter_changes(model, config, seed)
    book += time.monotonic() - t0
    counters.sync(device)
    setup_s = time.monotonic() - t_start - book
    if counters.on_card(device):
        log("memory", {"after_setup_bytes": torch.cuda.memory_allocated(device),
                       "setup_peak_bytes": counters.peak_bytes(device)})

    lead = group is None or group.rank == 0
    out = {"attempted": 0, "failed": 0, "e2e": {}, "ctx": None}
    if traced and lead:
        c0 = counters.read()
        tr = trace.profiled(lambda: trace.repeat(one, traffic["trace_steps"]),
                            lambda: counters.sync(device),
                            counters.on_card(device))
        launches = counters.delta(c0)
        per_step = {k: v / tr.steps for k, v in launches.items() if v}
        log("launches", {"per_step": per_step,
                         "expected": expected_launches(cfg)})
        rate = tr.steps * rows * S / tr.window_s
        shapes, shares = launch_shapes(config, cfg, traffic, shape)
        out["ctx"] = SimpleNamespace(
            kind="train", trace=tr, counters=launches, shapes=shapes,
            shares=shares, model=m, traffic=traffic,
            tokens_per_s=rate if group is None else rate / group.world,
            steps=tr.steps, flops_per_token=work.train_flops_per_token(m, S))
        out["trace"] = tr
        out["attempted"] = tr.steps
    elif traced:
        trace.repeat(one, traffic["trace_steps"])
    else:
        agree = None if group is None else group.agree
        steps_run, secs, ends = window.run(one, seconds, agree=agree)
        out["e2e"] = {"train_tokens_per_s": steps_run * rows * S / secs,
                      "setup_s": setup_s}
        out["attempted"] = steps_run
        log("window", {"steps": steps_run, "seconds": secs,
                       "step_s": window.intervals(ends)})
    peak = counters.peak_bytes(device)
    out["memory_peak_bytes"] = peak if group is None else group.max(peak)

    # the program's state is freed before the reference runs
    del state[:], model, step_fn, optimizer
    gc.collect()
    counters.release(device)  # and the peak, read above, starts anew
    t0 = time.monotonic()
    steps, ranks_differ = _shared_routes(steps, group)
    ref = reference(cell, seed, device, group, steps or None,
                    ref_lm.Precision("float32"))
    log("reference", {"seconds": time.monotonic() - t0, "loss": ref["loss"],
                      "program_loss": prog["loss"],
                      "grad_norm": ref["grad_norm"],
                      "program_grad_norm": prog["grad_norm"],
                      "peak_bytes": counters.peak_bytes(device)})
    out["numbers"] = compare.train_numbers(prog, ref)
    if n_moe:
        st = ref["moe"]
        log("moe", {"slots": st["slots"],
                    "dropped_share": st["dropped"] / st["slots"],
                    "capacity_fill": (st["slots"] - st["dropped"])
                    / st["capacity"]})
        out["numbers"].update(route_numbers(st, again, ranks_differ))
    out["reference"] = ref
    out["routes"] = steps
    return out
