#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. environment: versions, the card's name and power limit;
  2. build: every CUDA source under src/repro_torch/kernels/csrc with nvcc
     for sm_90a, into build/;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes and the edge cases, with the tolerance stated, and
     device times of kernel, plain version and PyTorch's own call;
  4. serve: jag-surrogate at full width through ServeEngine (batch 4,
     prompts of 32, 200 and 512 tokens, 32 new tokens each), with the
     kernel's launch count read around exactly that run, and the first-token
     logits held against a run of the plain versions.
The last line is {"ok": true, "device": {...}}.  Without a card, or without
the rest of the repository beside it, the script exits non-zero before it.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import env  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s, bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
TOL = {torch.float32: (2e-5, 1e-3), torch.bfloat16: (2e-2, 1e-2)}
BF16, F32 = torch.bfloat16, torch.float32

# (name, B, S, T, H, KV, D, dtype, causal, window, softcap, q_pos0)
SHAPES = [
    ("jag_prefill_512", 4, 512, 512, 4, 4, 64, BF16, True, None, None, 0),
    ("jag_prefill_200", 4, 200, 200, 4, 4, 64, BF16, True, None, None, 0),
    ("jag_prefill_32", 4, 32, 32, 4, 4, 64, BF16, True, None, None, 0),
    ("ragged", 2, 200, 200, 4, 4, 64, BF16, True, None, None, 0),
    ("granite_gqa", 1, 1024, 1024, 32, 8, 128, BF16, True, None, None, 0),
    ("cross", 1, 33, 70, 4, 1, 64, F32, False, None, None, 0),
    ("window64_softcap30", 2, 300, 300, 4, 2, 32, F32, True, 64, 30.0, 0),
    ("q_pos0_16", 1, 48, 64, 4, 4, 64, F32, True, None, None, 16),
]
MAIN_PATH = ("jag_prefill_512", "jag_prefill_200", "jag_prefill_32")
PROMPT_LENS, BATCH, NEW_TOKENS = (32, 200, 512), 4, 32


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def device_ms(fn, rounds=7, reps=20):
    """Median over rounds of the mean device time of ``reps`` back-to-back
    calls.  A spin kernel holds the stream while the host queues the calls,
    so host overhead between them is hidden and the events time the device."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


def valid_pairs(S, T, causal, window, q_pos0):
    """(query, key) pairs the mask keeps: the work these inputs need."""
    n = 0
    for s in range(S):
        qpos = q_pos0 + s
        hi = min(T, qpos + 1) if causal else T
        lo = max(0, qpos - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def time_kernel(q, k, v, out, kw):
    """Device times of the kernel, its plain version and PyTorch's own
    attention call on the same inputs, beside the card's bound."""
    B, S, H, D = q.shape
    T = k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
    flops = 4 * B * H * D * valid_pairs(S, T, kw["causal"], kw["window"],
                                        kw["q_pos0"])
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return {
        "ms": device_ms(lambda: fak.flash_attention(q, k, v, **kw)),
        "plain_ms": device_ms(lambda: ref.flash_attention_ref(q, k, v, **kw)),
        "library_ms": device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=kw["causal"], scale=1.0 / D ** 0.5)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops}


def phase_env():
    snap = env.snapshot()
    say("env", **snap)
    if not snap["nvidia_smi"]:
        raise RuntimeError("nvidia-smi did not report the card")
    return snap


def phase_build():
    t0 = time.monotonic()
    libs = _build.build_all()
    secs = time.monotonic() - t0
    for name, log in _build.logs.items():
        for line in log.splitlines():  # per instance: entry, spills, registers
            if "spill" in line or ("ptxas info" in line and (
                    "registers" in line or "Compiling" in line)):
                print(f"[build] {name}: {line.strip()}", flush=True)
    say("build", seconds=round(secs, 3), libraries=sorted(libs),
        built_now=sorted(_build.logs))
    if "flash_attention" not in libs:
        raise RuntimeError("flash_attention library missing after build")


def phase_kernels(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    errs, timing = {}, {}
    for (name, B, S, T, H, KV, D, dt, causal, window, softcap,
         q_pos0) in SHAPES:
        q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, T, KV, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, T, KV, D, generator=gen, device=dev).to(dt)
        kw = dict(causal=causal, window=window, softcap_val=softcap,
                  q_pos0=q_pos0)
        got = fak.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, **kw)
        diff = (got.float() - want.float()).abs()
        atol, rtol = TOL[dt]
        ok = bool(torch.isfinite(got.float()).all()
                  and (diff <= atol + rtol * want.float().abs()).all())
        err = float(diff.max())
        errs[name] = err
        say("kernel_vs_plain", kernel="flash_attention", shape=name,
            B=B, S=S, T=T, H=H, KV=KV, D=D, dtype=str(dt).split(".")[-1],
            causal=causal, window=window, softcap=softcap, q_pos0=q_pos0,
            max_abs_err=err, atol=atol, rtol=rtol, ok=ok)
        if not ok:
            raise RuntimeError(f"flash_attention disagrees with its plain "
                               f"version at {name}: max abs err {err}")
        if name in MAIN_PATH:
            t = timing[name] = time_kernel(q, k, v, got, kw)
            say("kernel_time", kernel="flash_attention", shape=name,
                measured_on=torch.cuda.get_device_name(0),
                nvidia_smi=env.nvidia_smi_line(), kernel_ms=t["ms"],
                **{key: val for key, val in t.items() if key != "ms"})
    return errs, timing


@torch.inference_mode()
def phase_serve(dev):
    cfg = registry.get_config("jag-surrogate")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    max_len = max(PROMPT_LENS) + NEW_TOKENS + 8
    eng = ServeEngine(cfg, params, max_len=max_len)
    gen = torch.Generator(device=dev).manual_seed(1)
    requests = [torch.randint(0, cfg.vocab_size, (BATCH, n), generator=gen,
                              device=dev) for n in PROMPT_LENS]
    eng.generate(requests[0][:, :8], 2)  # warm-up: library handles, allocator
    eng.stats = {k: type(v)() for k, v in eng.stats.items()}

    fak.launches = 0
    outs = [eng.generate(t, NEW_TOKENS) for t in requests]
    launches = fak.launches

    want = len(PROMPT_LENS) * cfg.n_layers
    if launches != want:
        raise RuntimeError(f"flash_attention launched {launches} times in the "
                           f"serve run, expected {want} (n_layers per prefill)")
    for t, out in zip(requests, outs):
        if tuple(out.shape) != (BATCH, NEW_TOKENS):
            raise RuntimeError(f"generated shape {tuple(out.shape)}")
        if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
            raise RuntimeError("generated tokens out of vocabulary range")

    plain = ServeEngine(cfg.replace(use_pallas="never"), params, max_len=max_len)
    rels = []
    for t in requests:
        lk, caches = eng.prefill_fn(params, t)
        before = fak.launches
        lp, _ = plain.prefill_fn(params, t)
        if fak.launches != before:
            raise RuntimeError("the plain run launched the kernel")
        ld, _ = eng.decode_fn(params, lk[:, -1].argmax(-1)[:, None], caches)
        lk, lp, ld = lk.float(), lp.float(), ld.float()
        if not (torch.isfinite(lk).all() and torch.isfinite(ld).all()):
            raise RuntimeError("non-finite logits")
        rel = float((lk - lp).abs().max() / lp.abs().max())
        rels.append(rel)
        if rel > 5e-2:
            raise RuntimeError(f"first-token logits differ from the plain run "
                               f"by rel {rel} at prompt {t.shape[1]}")
    s = eng.stats
    say("serve", arch=cfg.arch_id, batch=BATCH, prompt_lens=list(PROMPT_LENS),
        new_tokens=NEW_TOKENS, n_layers=cfg.n_layers, d_model=cfg.d_model,
        flash_launches=launches, expected_launches=want,
        first_token_rel_err=rels, rel_tol=5e-2,
        prefill_tok_per_s=s["prefill_tokens"] / s["prefill_s"],
        decode_tok_per_s=s["decode_tokens"] / s["decode_s"],
        stats=s, measured_on=torch.cuda.get_device_name(0),
        nvidia_smi=env.nvidia_smi_line())
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 2
    dev = env.device("cuda")
    snap = phase_env()
    phase_build()
    errs, timing = phase_kernels(dev)
    launches = phase_serve(dev)
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "launches": launches,
        "max_abs_err": max(errs[n] for n in MAIN_PATH),
        **{key: timing["jag_prefill_512"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}]}),
        flush=True)
    print(snap["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
