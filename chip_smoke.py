#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. environment: versions, the card's name and power limit;
  2. build: every CUDA source under src/repro_torch/kernels/csrc with nvcc
     for sm_90a, into build/ (flash_attention, wkv6_scan, ssd_scan); then
     the tensor-core instructions of each kernel function (cuobjdump -sass),
     which every bf16 flash, WKV6 and SSD instance must have;
  3. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and the edge cases, with the tolerance stated, and
     device times of kernel, plain version and PyTorch's own call (where
     one call computes the same function) beside the card's bound;
  4. serve: jag-surrogate, rwkv6-3b and zamba2-1.2b at full width and full
     depth through ServeEngine (random weights from seed 0; batch 4,
     prompts of 32, 200 and 512 tokens, 32 new tokens each).  Every launch
     count is set to 0 just before each model's run and read just after;
     the counts must be exact (jag 12 flash; rwkv6-3b 96 WKV; zamba2 99 SSD
     and 15 flash), and the first-token logits are held against a run of
     the plain versions.
The last line is {"ok": true, "device": {...}}.  Without a card, or without
the rest of the repository beside it, the script exits non-zero before it.
"""
from __future__ import annotations

import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import env  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402
from repro_torch.kernels import ssd_scan as ssdk  # noqa: E402
from repro_torch.kernels import wkv6_scan as wkvk  # noqa: E402
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
    # zamba2-1.2b's shared attention: 32 heads of 64 over concat(x, x0)
    ("zamba2_prefill_512", 4, 512, 512, 32, 32, 64, BF16, True, None, None, 0),
    ("zamba2_prefill_200", 4, 200, 200, 32, 32, 64, BF16, True, None, None, 0),
    ("zamba2_prefill_32", 4, 32, 32, 32, 32, 64, BF16, True, None, None, 0),
    # bf16 on the tensor cores: every feature and ragged edge of the tiling
    ("bf16_window64_softcap30_D32", 2, 300, 300, 4, 2, 32, BF16, True, 64,
     30.0, 0),
    ("bf16_D16", 1, 130, 130, 2, 1, 16, BF16, True, None, None, 0),
    ("bf16_D128_gqa_ragged", 2, 200, 200, 8, 2, 128, BF16, True, None, None,
     0),
    ("bf16_cross", 1, 33, 70, 4, 1, 64, BF16, False, None, None, 0),
    ("bf16_S1_q_pos0_100", 2, 1, 101, 4, 4, 64, BF16, True, None, None, 100),
    ("bf16_ragged_S45_T83", 1, 45, 83, 4, 2, 64, BF16, False, None, None, 0),
]
MAIN_PATH = ("jag_prefill_512", "jag_prefill_200", "jag_prefill_32",
             "zamba2_prefill_512", "zamba2_prefill_200", "zamba2_prefill_32")
PROMPT_LENS, BATCH, NEW_TOKENS = (32, 200, 512), 4, 32
KERNELS = {"flash_attention": fak, "wkv6_scan": wkvk, "ssd_scan": ssdk}

# Scans: max |kernel - plain| / max |plain| below SCAN_REL.  float32 is
# tests/test_kernels.py's bar; a bf16 output is rounded to 8 mantissa bits
# and summed in another order than the plain version's.
SCAN_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (name, B, S, H, D, decay, dtype, chunk): rwkv6-3b's prefills (H=40, D=64,
# chunk min(64, S); 200 tokens are padded to 256), then the edge cases.
# decay "sigmoid": w = sigmoid(N(0,1) + 2); "strong": w = exp(-exp(N(1, 2))),
# which reaches the clip at 1e-12 as rwkv6-3b's decays can.
WKV_SHAPES = [
    ("rwkv6_prefill_512", 4, 512, 40, 64, "sigmoid", BF16, 64),
    ("rwkv6_prefill_200", 4, 256, 40, 64, "sigmoid", BF16, 64),
    ("rwkv6_prefill_32", 4, 32, 40, 64, "sigmoid", BF16, 32),
    ("f32_D64", 2, 256, 8, 64, "sigmoid", F32, 64),
    ("f32_D16", 2, 128, 4, 16, "sigmoid", F32, 64),
    ("f32_D32_ragged", 1, 100, 4, 32, "sigmoid", F32, 100),
    ("bf16_B1_ragged", 1, 77, 40, 64, "sigmoid", BF16, 77),
    ("strong_rwkv6_512", 4, 512, 40, 64, "strong", BF16, 64),
    ("strong_S1", 2, 1, 40, 64, "strong", BF16, 1),
    ("strong_S15", 2, 15, 40, 64, "strong", BF16, 15),
    ("strong_S17", 2, 17, 40, 64, "strong", BF16, 17),
    ("strong_B1_H40", 1, 77, 40, 64, "strong", BF16, 77),
]
WKV_MAIN = ("rwkv6_prefill_512", "rwkv6_prefill_200", "rwkv6_prefill_32")
# (name, B, S, H, P, N, decay, dtype, chunk): zamba2-1.2b's prefills (H=64,
# P=N=64, chunk min(256, S)), then the edge cases.  decay "normal": dt =
# softplus(N(0,1)) / 2, A = -exp(N(0,1)); "strong": dt = softplus(N(0,1)),
# A = -exp(N(1.5,1)), about e^-3 a step, held to the sequential oracle (the
# chunked form's long cumsums cancel in their differences).
SSD_SHAPES = [
    ("zamba2_prefill_512", 4, 512, 64, 64, 64, "normal", BF16, 256),
    ("zamba2_prefill_200", 4, 200, 64, 64, 64, "normal", BF16, 200),
    ("zamba2_prefill_32", 4, 32, 64, 64, 64, "normal", BF16, 32),
    ("f32_P64", 2, 256, 8, 64, 64, "normal", F32, 128),
    ("f32_P16_N16", 2, 128, 4, 16, 16, "normal", F32, 64),
    ("f32_P32_N128_ragged", 1, 100, 4, 32, 128, "normal", F32, 100),
    ("bf16_B1_ragged", 1, 77, 64, 64, 64, "normal", BF16, 77),
    # bf16 on the tensor cores: every P and N split and ragged edge
    ("bf16_P16_N16", 2, 128, 4, 16, 16, "normal", BF16, 64),
    ("bf16_P32_N128_ragged", 1, 100, 4, 32, 128, "normal", BF16, 100),
    ("bf16_S1", 2, 1, 64, 64, 64, "normal", BF16, 1),
    ("bf16_S65", 2, 65, 64, 64, 64, "normal", BF16, 65),
    ("strong_zamba2_512", 4, 512, 64, 64, 64, "strong", BF16, 256),
]
SSD_MAIN = ("zamba2_prefill_512", "zamba2_prefill_200", "zamba2_prefill_32")
# float32-compute serve run against its plain run: rounding only
FP32_SERVE_REL = 1e-3
# serve: arch -> the launches each prefill must make, per kernel
SERVE = {
    "jag-surrogate": lambda cfg: {"flash_attention": cfg.n_layers},
    "rwkv6-3b": lambda cfg: {"wkv6_scan": _count(cfg, "rwkv6")},
    "zamba2-1.2b": lambda cfg: {"ssd_scan": _count(cfg, "mamba2"),
                                "flash_attention": _count(cfg, "shared_attn")},
}


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


def sdpa_backends(qt, kt, vt, causal, scale):
    """Device ms of scaled_dot_product_attention restricted to each backend
    (None where the backend refuses these inputs), to say which one its
    default dispatch matches."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name)

        def call():
            with sdpa_kernel([backend]):
                torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale)
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError:
            out[name] = None
            continue
        out[name] = device_ms(call)
    return out


def time_kernel(q, k, v, out, kw):
    """Device times of the kernel, its plain version and PyTorch's own
    attention call on the same inputs (by default and per backend), beside
    the card's bound."""
    B, S, H, D = q.shape
    T = k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
    flops = 4 * B * H * D * valid_pairs(S, T, kw["causal"], kw["window"],
                                        kw["q_pos0"])
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t = {
        "ms": device_ms(lambda: fak.flash_attention(q, k, v, **kw)),
        "plain_ms": device_ms(lambda: ref.flash_attention_ref(q, k, v, **kw)),
        "library_ms": device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=kw["causal"], scale=1.0 / D ** 0.5)),
        "library_backend_ms": sdpa_backends(qt, kt, vt, kw["causal"],
                                            1.0 / D ** 0.5),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops}
    t["kernel_over_bound"] = t["ms"] / t["bound_ms"]
    t["kernel_over_library"] = t["ms"] / t["library_ms"]
    return t


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
    missing = sorted(set(KERNELS) - set(libs))
    if missing:
        raise RuntimeError(f"libraries missing after build: {missing}")


def phase_sass():
    """Tensor-core instructions (HMMA, HGMMA) per kernel function of each
    built library, read from ``cuobjdump -sass``.  Every bf16 instance of
    the three kernels must have some: their products run on the tensor
    cores (4 flash head dims, 3 WKV head dims, 3 x 4 SSD P and N)."""
    nvcc = env.nvcc_path()
    tool = shutil.which("cuobjdump") or (
        os.path.join(os.path.dirname(nvcc), "cuobjdump") if nvcc else None)
    if tool is None or not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found beside nvcc")
    counts = {}
    for name in KERNELS:
        text = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        fn = None
        for line in text.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                fn = found.group(1)
                counts[fn] = 0
            elif fn and re.search(r"\bH(G)?MMA\b", line):
                counts[fn] += 1
    say("sass", tensor_core_instructions=counts)
    bf16 = [fn for fn in counts if "flash_fwd_bf16" in fn
            or ("wkv6_kernel" in fn and "bfloat16" in fn)
            or "ssd_tc_kernel" in fn]
    if len(bf16) != 19 or not all(counts[fn] for fn in bf16):
        raise RuntimeError(f"bf16 flash / WKV6 / SSD instances without "
                           f"tensor-core instructions: {counts}")


def phase_flash(dev):
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


def _count(cfg, kind):
    return sum(spec.kind == kind for spec in cfg.plan)


def _bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _tiles(S, tile=64):
    """Row counts of the kernels' 64-row time tiles over S."""
    return [min(tile, S - t0) for t0 in range(0, S, tile)]


def wkv_work(r, k, v, w, u):
    """Bytes (r, k, v, y in r's dtype, w and u in float32, each once) and
    the products of the chunked algorithm at the kernel's 16-row chunks:
    att over the pairs s < t, the bonus, att.v, the inter-chunk term and the
    state update."""
    B, S, H, D = r.shape
    nbytes = 4 * r.numel() * r.element_size() + (w.numel() + u.numel()) * 4
    flops = 0
    for n in _tiles(S, 16):
        pairs = n * (n - 1) // 2
        flops += 3 * pairs * D + 3 * n * D + 2 * (pairs + n) * D \
            + 4 * n * D * D + D * D
    return _bound(nbytes, B * H * flops)


def ssd_work(x, dt, A, Bm, Cm):
    """Bytes (x, y, B, C in x's dtype, dt and A in float32, each once) and
    the products of the chunked algorithm at the kernel's 64-row tiles:
    C.B^T and W over the pairs s <= t, W.x, C.h^T and the state update."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nbytes = (2 * x.numel() + 2 * Bm.numel()) * x.element_size() \
        + (dt.numel() + A.numel()) * 4
    flops = 0
    for n in _tiles(S):
        pairs = n * (n + 1) // 2
        flops += 2 * pairs * N + 3 * pairs + 2 * pairs * P + 4 * n * N * P \
            + P * N
    return _bound(nbytes, B * H * flops)


def wkv_inputs(gen, dev, B, S, H, D, decay, dt):
    r, k, v = (torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
               for _ in range(3))
    n = torch.randn(B, S, H, D, generator=gen, device=dev)
    w = torch.exp(-torch.exp(1.0 + 2.0 * n)) if decay == "strong" \
        else torch.sigmoid(n + 2.0)
    u = torch.randn(H, D, generator=gen, device=dev) * 0.1
    return r, k, v, w, u


def ssd_inputs(gen, dev, B, S, H, P, N, decay, dt):
    strong = decay == "strong"
    x = torch.randn(B, S, H, P, generator=gen, device=dev).to(dt)
    dtv = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device=dev))
    dtv = dtv if strong else dtv * 0.5
    A = -torch.exp(torch.randn(H, generator=gen, device=dev)
                   + (1.5 if strong else 0.0))
    Bm = torch.randn(B, S, N, generator=gen, device=dev).to(dt)
    Cm = torch.randn(B, S, N, generator=gen, device=dev).to(dt)
    return x, dtv, A, Bm, Cm


def phase_scan(dev, name, mod, plain, shapes, main, make, work):
    """One scan kernel against its plain version at every shape, timed at
    the main path's shapes.  ``plain`` maps each shape's decay kind (the
    last of its dims) to the plain version it is held to."""
    gen = torch.Generator(device=dev).manual_seed(0)
    errs, timing = {}, {}
    for shape, *dims, dt, chunk in shapes:
        args = make(gen, dev, *dims, dt)
        got = getattr(mod, name)(*args, chunk=chunk)
        torch.cuda.synchronize()
        want = plain[dims[-1]](*args, chunk=chunk)
        err = float((got.float() - want.float()).abs().max())
        rel = err / float(want.float().abs().max())
        ok = bool(torch.isfinite(got.float()).all() and rel < SCAN_REL[dt])
        errs[shape] = err
        say("kernel_vs_plain", kernel=name, shape=shape, dims=dims,
            dtype=str(dt).split(".")[-1], chunk=chunk, max_abs_err=err,
            rel_err=rel, rel_tol=SCAN_REL[dt], ok=ok)
        if not ok:
            raise RuntimeError(f"{name} disagrees with its plain version at "
                               f"{shape}: rel err {rel}")
        if shape in main:
            t = timing[shape] = {
                "ms": device_ms(lambda: getattr(mod, name)(*args, chunk=chunk)),
                "plain_ms": device_ms(
                    lambda: plain[dims[-1]](*args, chunk=chunk)),
                "library_ms": None,  # no one PyTorch call computes the scan
                **work(*args)}
            t["kernel_over_bound"] = t["ms"] / t["bound_ms"]
            say("kernel_time", kernel=name, shape=shape,
                measured_on=torch.cuda.get_device_name(0),
                nvidia_smi=env.nvidia_smi_line(), kernel_ms=t["ms"],
                **{key: val for key, val in t.items() if key != "ms"})
    return errs, timing


def _launches():
    return {name: mod.launches for name, mod in KERNELS.items()}


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def _free():
    gc.collect()
    torch.cuda.empty_cache()


@torch.inference_mode()
def phase_serve(dev, arch):
    """Serve one model at full width and depth; returns its launch counts."""
    cfg = registry.get_config(arch)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    max_len = max(PROMPT_LENS) + NEW_TOKENS + 8
    eng = ServeEngine(cfg, params, max_len=max_len)
    gen = torch.Generator(device=dev).manual_seed(1)
    requests = [torch.randint(0, cfg.vocab_size, (BATCH, n), generator=gen,
                              device=dev) for n in PROMPT_LENS]
    eng.generate(requests[0][:, :8], 2)  # warm-up: library handles, allocator
    eng.stats = {k: type(v)() for k, v in eng.stats.items()}

    for mod in KERNELS.values():
        mod.launches = 0
    outs = [eng.generate(t, NEW_TOKENS) for t in requests]
    launches = _launches()

    per_prefill = SERVE[arch](cfg)
    want = {name: len(PROMPT_LENS) * per_prefill.get(name, 0)
            for name in KERNELS}
    if launches != want:
        raise RuntimeError(f"{arch}: kernel launches {launches} in the serve "
                           f"run, expected {want}")
    for t, out in zip(requests, outs):
        if tuple(out.shape) != (BATCH, NEW_TOKENS):
            raise RuntimeError(f"generated shape {tuple(out.shape)}")
        if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
            raise RuntimeError("generated tokens out of vocabulary range")

    # The plain versions the kernels are held to: for rwkv6 the chunked WKV
    # algorithm the kernel computes.  A deep random-weight model amplifies
    # bf16 rounding, so the bf16 bar is 5e-2 or, where the model has two
    # plain versions (rwkv6: blocked, which rounds its operands to bf16, and
    # chunked), the distance between those two, whichever is larger.  A
    # float32-compute run at the longest prompt holds the kernels' arithmetic
    # end to end at FP32_SERVE_REL.
    plain = ServeEngine(cfg.replace(use_pallas="never", wkv_impl="chunked"),
                        params, max_len=max_len)
    blocked = (ServeEngine(cfg.replace(use_pallas="never"), params,
                           max_len=max_len)
               if cfg.wkv_impl == "blocked" else None)
    rels, bars = [], []
    for t in requests:
        lk, caches = eng.prefill_fn(params, t)
        before = _launches()
        lp, _ = plain.prefill_fn(params, t)
        lb = blocked.prefill_fn(params, t)[0].float() if blocked else None
        if _launches() != before:
            raise RuntimeError("the plain run launched a kernel")
        ld, _ = eng.decode_fn(params, lk[:, -1].argmax(-1)[:, None], caches)
        lk, lp, ld = lk.float(), lp.float(), ld.float()
        if not (torch.isfinite(lk).all() and torch.isfinite(ld).all()):
            raise RuntimeError("non-finite logits")
        rel = _rel(lk, lp)
        bar = max(5e-2, _rel(lb, lp)) if lb is not None else 5e-2
        rels.append(rel)
        bars.append(bar)
        if rel > bar:
            raise RuntimeError(f"{arch}: first-token logits differ from the "
                               f"plain run by rel {rel} > {bar} at prompt "
                               f"{t.shape[1]}")
    cfg32 = cfg.replace(compute_dtype="float32")
    before = _launches()
    lk32 = ServeEngine(cfg32, params, max_len=max_len).prefill_fn(
        params, requests[-1])[0]
    ran = {name: n - before[name] for name, n in _launches().items()}
    if ran != {name: n // len(PROMPT_LENS) for name, n in want.items()}:
        raise RuntimeError(f"the float32 run launched {ran}")
    lp32 = ServeEngine(cfg32.replace(use_pallas="never", wkv_impl="chunked"),
                       params, max_len=max_len).prefill_fn(params, requests[-1])[0]
    rel32 = _rel(lk32, lp32)
    if not rel32 < FP32_SERVE_REL:
        raise RuntimeError(f"{arch}: float32 first-token logits differ from "
                           f"the plain run by rel {rel32}")
    s = eng.stats
    say("serve", arch=cfg.arch_id, batch=BATCH, prompt_lens=list(PROMPT_LENS),
        new_tokens=NEW_TOKENS, n_layers=cfg.n_layers, d_model=cfg.d_model,
        **{f"{name.split('_')[0]}_launches": n for name, n in launches.items()},
        expected_launches=want, first_token_rel_err=rels, rel_tol=bars,
        fp32_first_token_rel_err=rel32, fp32_rel_tol=FP32_SERVE_REL,
        prefill_tok_per_s=s["prefill_tokens"] / s["prefill_s"],
        decode_tok_per_s=s["decode_tokens"] / s["decode_s"],
        stats=s, max_memory_allocated=torch.cuda.max_memory_allocated(),
        measured_on=torch.cuda.get_device_name(0),
        nvidia_smi=env.nvidia_smi_line())
    del eng, plain, blocked, params, caches
    _free()
    return launches


SOURCES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:26",
    "wkv6_scan": "src/repro/kernels/wkv6_scan.py:18",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:21",
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 2
    dev = env.device("cuda")
    snap = phase_env()
    phase_build()
    phase_sass()
    errs, timing = {}, {}
    errs["flash_attention"], t = phase_flash(dev)
    timing["flash_attention"] = t["jag_prefill_512"]
    main_shapes = {"flash_attention": MAIN_PATH}
    for name, mod, plain, shapes, main_, make, work in (
            ("wkv6_scan", wkvk, {"sigmoid": ref.wkv6_chunked_ref,
                                 "strong": ref.wkv6_chunked_ref},
             WKV_SHAPES, WKV_MAIN, wkv_inputs, wkv_work),
            ("ssd_scan", ssdk, {"normal": ref.ssd_chunked_ref,
                                "strong": ref.ssd_scan_ref},
             SSD_SHAPES, SSD_MAIN, ssd_inputs, ssd_work)):
        errs[name], t = phase_scan(dev, name, mod, plain, shapes, main_, make,
                                   work)
        timing[name] = t[main_[0]]
        main_shapes[name] = main_
    _free()
    launches = {name: 0 for name in KERNELS}
    for arch in SERVE:  # each model's counts are read around its own run
        for name, n in phase_serve(dev, arch).items():
            launches[name] += n
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": SOURCES[name],
        "launches": launches[name],
        "max_abs_err": max(errs[name][n] for n in main_shapes[name]),
        **{key: timing[name][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name in KERNELS]}), flush=True)
    print(snap["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
