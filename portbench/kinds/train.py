"""Training traffic: rows of uniform tokens through the port's training
step, as ``Trainer`` builds it (``make_optimizer`` of the config's
optimizer, ``make_train_step``), without checkpoint saves.

Set-up builds one state (the model with the seed's weights and fresh
AdamW state) and drives it through ``warm_steps`` steps of the window's
own call and feed, which the reference follows.  The same state then runs
the window.  Every step has rows of its own (``weights.train_batch``).

Traffic keys: ``rows`` and ``seq_len`` a step, ``warm_steps``,
``trace_steps`` (steps under the profiler with ``--trace 1``).
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from portbench import layers
from portbench.lib import compare, counters, program, trace, weights, window, work
from portbench.reference import lm as ref_lm
from portbench.reference import train as ref_train


def launch_shapes(config: dict, cfg, traffic: dict) -> dict:
    """{kernel: the shape of its launches in a step} (one a layer and
    microbatch), for each layer kind's hand-written kernel."""
    m, S = config["model"], traffic["seq_len"]
    b = traffic["rows"] // max(1, cfg.microbatch)
    ks = (layers.get(kind).KERNEL for kind in dict.fromkeys(ref_lm.plan(m)))
    return {k.name: k.launch_shape(m, b, S) for k in ks if k is not None}


def expected_launches(cfg) -> dict:
    """Kernel calls a step: a layer's forward once a microbatch in the
    prologue and twice under remat full (the recompute), its backward
    once."""
    n_mb, n_pro = max(1, cfg.microbatch), len(cfg.prologue)
    twice = 1 if cfg.remat == "none" else 2
    out = {}
    for i, spec in enumerate(cfg.plan):
        k = layers.get(spec.kind).KERNEL
        if k:
            fwd = 1 if i < n_pro else twice
            out[k.name] = out.get(k.name, 0) + fwd * n_mb
            out[k.name + "_bwd"] = out.get(k.name + "_bwd", 0) + n_mb
    return out


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        log) -> dict:
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
    step_fn = trainstep.make_train_step(cfg, optimizer)
    model = program.port_model(cfg, config, seed, device)
    state = [trainstep.TrainState(
        model, optimizer.init(trainstep.named_params(model)),
        torch.zeros((), dtype=torch.int32, device=device))]
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

    prog = {"loss": []}
    book = 0.0  # the checks' bookkeeping inside set-up, not set-up
    for i in range(warm):
        met = one()
        t0 = time.monotonic()
        prog["loss"].append(met["loss"])
        if i == 0:
            prog["grad_norm"] = float(met["grad_norm"])
            prog["grad_leaf"] = {
                k: float(torch.linalg.vector_norm(v)) / (1 - o["b1"])
                for k, v in state[0].opt["m"].items()}
        book += time.monotonic() - t0
    t0 = time.monotonic()
    prog["change_leaf"] = program.parameter_changes(model, config, seed)
    book += time.monotonic() - t0
    counters.sync(device)
    setup_s = time.monotonic() - t_start - book

    out = {"attempted": 0, "failed": 0, "e2e": {}, "ctx": None}
    if traced:
        c0 = counters.read()
        tr = trace.profiled(lambda: trace.repeat(one, traffic["trace_steps"]),
                            lambda: counters.sync(device),
                            counters.on_card(device))
        launches = counters.delta(c0)
        per_step = {k: v / tr.steps for k, v in launches.items() if v}
        log("launches", {"per_step": per_step,
                         "expected": expected_launches(cfg)})
        rate = tr.steps * rows * S / tr.window_s
        out["ctx"] = SimpleNamespace(
            kind="train", trace=tr, counters=launches,
            shapes=launch_shapes(config, cfg, traffic), model=m,
            traffic=traffic, tokens_per_s=rate, steps=tr.steps,
            flops_per_token=work.train_flops_per_token(m, S))
        out["trace"] = tr
        out["attempted"] = tr.steps
    else:
        steps, secs, ends = window.run(one, seconds)
        out["e2e"] = {"train_tokens_per_s": steps * rows * S / secs,
                      "setup_s": setup_s}
        out["attempted"] = steps
        log("window", {"steps": steps, "seconds": secs,
                       "step_s": window.intervals(ends)})
    out["memory_peak_bytes"] = counters.peak_bytes(device)

    # the program's state is freed before the reference runs
    del state[:], model, step_fn, optimizer
    gc.collect()
    counters.release(device)
    t0 = time.monotonic()
    ref_lm.pin_float32()
    shapes = ref_lm.param_shapes(m)
    p0 = weights.draw_all(shapes, config["init"], seed, device)
    ref = ref_train.follow(p0, [feed(i) for i in range(warm)], m, o,
                           ref_lm.Precision("float32"))
    log("reference", {"seconds": time.monotonic() - t0, "loss": ref["loss"],
                      "program_loss": prog["loss"],
                      "grad_norm": ref["grad_norm"],
                      "program_grad_norm": prog["grad_norm"]})
    out["numbers"] = compare.train_numbers(prog, ref)
    out["reference"] = ref
    return out
