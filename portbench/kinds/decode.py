"""Decode traffic: every row's prompt prefilled through the port's
``make_prefill_fn``, then greedy decode of all rows together through
``make_decode_fn``, closed loop: each step feeds the tokens the last one
produced, and ends when its tokens reach the host, as a streaming server
sends them.  The inter-token latency of a step runs from the previous
step's tokens on the host to its own.

Set-up prefills the rows in groups of ``prefill_rows`` (one call of the
whole batch does not fit beside the caches) into caches for all rows made
by the port's ``init_caches``, and decodes ``warm_steps`` steps.  Every
served token, set-up's included, is kept on the host for the check.

Traffic keys: ``rows``, ``prompt_len``, ``prefill_rows``,
``max_new_tokens`` (the caches' room), ``warm_steps``, ``trace_steps``,
``checked_rows`` (rows drawn from the seed whose served tokens the
reference judges).
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.lib import counters, program, trace, weights, window, work
from portbench.reference import lm as ref_lm


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        log) -> dict:
    config, traffic = cell.config, cell.traffic
    m = config["model"]
    rows, plen, V = traffic["rows"], traffic["prompt_len"], m["vocab_size"]
    cfg = program.port_config(config)
    from repro_torch.models import lm
    from repro_torch.serve import engine

    cache_dtype = getattr(torch, config["precision"]["cache"])
    max_len = plen + traffic["max_new_tokens"]
    model = program.port_model(cfg, config, seed, device)
    model.requires_grad_(False)
    prefill = engine.make_prefill_fn(cfg, max_len, cache_dtype=cache_dtype)
    decode = engine.make_decode_fn(cfg)
    prompts = weights.tokens(device, seed, "prompts", rows, plen, V)
    served = []  # (rows,) host tensors, one a step
    live = {}

    def one():
        lg, live["caches"] = decode(model, live["tok"][:, None], live["caches"])
        live["tok"] = torch.argmax(lg, -1)
        served.append(live["tok"].cpu())

    with torch.inference_mode():
        caches = lm.init_caches(cfg, rows, max_len, cache_dtype, device)
        first, g = [], traffic["prefill_rows"]
        for r0 in range(0, rows, g):
            lg, c = prefill(model, prompts[r0:r0 + g])
            for dst, src in zip(caches["layers"], c["layers"]):
                for k, t in src.items():
                    dst[k][r0:r0 + g].copy_(t)
            first.append(torch.argmax(lg[:, -1], -1))
            del lg, c
        caches["pos"] = plen
        live.update(caches=caches, tok=torch.cat(first))
        del caches, first
        served.append(live["tok"].cpu())
        for _ in range(traffic["warm_steps"]):
            one()
        counters.sync(device)
        setup_s = time.monotonic() - t_start

        out = {"attempted": rows, "failed": 0, "e2e": {}, "ctx": None}
        if traced:
            c0 = counters.read()
            n = traffic["trace_steps"]
            tr = trace.profiled(lambda: trace.repeat(one, n),
                                lambda: counters.sync(device),
                            counters.on_card(device))
            launches = counters.delta(c0)
            log("launches", {"per_step": {k: v / n for k, v in launches.items()},
                             "expected": {}})
            out["ctx"] = SimpleNamespace(
                kind="decode", trace=tr, counters=launches, shapes={}, model=m,
                traffic=traffic, tokens_per_s=n * rows / tr.window_s, steps=n,
                flops_per_token=work.decode_flops_per_token(
                    m, plen + len(served) - 1))
            out["trace"] = tr
        else:
            steps, secs, ends = window.run(one, seconds)
            itl_ms = 1e3 * np.array(window.intervals(ends))
            out["e2e"] = {"decode_tokens_per_s": steps * rows / secs,
                          "decode_itl_p95_ms": float(np.percentile(itl_ms, 95)),
                          "setup_s": setup_s}
            log("window", {"steps": steps, "seconds": secs,
                           "itl_p50_ms": float(np.percentile(itl_ms, 50))})
    out["memory_peak_bytes"] = counters.peak_bytes(device)

    # the program's state is freed before the reference runs
    del model, live["caches"], prefill, decode
    gc.collect()
    counters.release(device)
    t0 = time.monotonic()
    out["served"], out["prompts"] = torch.stack(served, 1), prompts
    out["numbers"] = {"logit_gap": {"value": served_gap(
        config, seed, prompts, out["served"], traffic["checked_rows"],
        ref_lm.Precision("float32"), device)}}
    log("reference", {"seconds": time.monotonic() - t0,
                      "served_tokens_a_row": len(served),
                      "rows": traffic["checked_rows"]})
    return out


def checked_rows(seed: int, rows: int, n: int):
    g = weights.generator("cpu", seed, "checked rows")
    return torch.randperm(rows, generator=g)[:n].tolist()


@torch.no_grad()
def served_gap(config, seed, prompts, served, n_rows, prec, device) -> float:
    """The widest gap, over the checked rows' served tokens, by which the
    float32 reference's logit of a served token lies below its best at
    that position.  ``served`` (rows, T) on the host.  With ``prec`` other
    than the reference itself (the control, or a planted fault) the token
    judged at each position is the one ``prec`` puts first, not the served
    one."""
    m = config["model"]
    ref_lm.pin_float32()
    p = weights.draw_all(ref_lm.param_shapes(m), config["init"], seed, device)
    f32 = ref_lm.Precision("float32")
    plen, worst = prompts.shape[1], 0.0
    for b in checked_rows(seed, prompts.shape[0], n_rows):
        toks = served[b].to(device)
        seq = torch.cat([prompts[b], toks[:-1]])[None]
        lg = ref_lm.logits(p, seq, m, f32)[0, plen - 1:]
        pick = toks if prec.exact else \
            ref_lm.logits(p, seq, m, prec)[0, plen - 1:].argmax(-1)
        gap = lg.max(-1).values - lg.gather(-1, pick[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        del lg
    return worst
