#!/usr/bin/env python3
"""The scans' bf16 backward kernels against the scalar design they replace,
timed in turns on one card at the timed shapes of ``chip_smoke.py``
(``WKV_BWD_TIMED`` / ``SSD_BWD_TIMED``: one 8-token row of the quickstart's
bundles, a 128-token microbatch of 8 rows, one 4096-step row).

    python3 tools/scan_bwd_variants.py [--rounds 2] [--heads]

``kernel`` is ``csrc/{wkv6,ssd}_scan_bwd.cu`` as it stands, called at its
bf16 entry (``*_scan_bwd_tc``).  ``scalar`` is the same source with one
exact edit (``EDITS``): its float32 entry, the scalar walk over time of
PR 23 kept for the float32 parity path, also dispatches bfloat16, so the
old design runs on the same bf16 inputs.  Both are built with the repo's
nvcc flags into ``build/scan_bwd_variants/`` and timed with
``chip_smoke.device_ms``, in turns, ``--rounds`` times each way, on
preallocated outputs and scratch.  Each variant's gradients are held to
the plain version (``ref.*_scan_bwd_ref``; the kernel also to its mirror
``ref.*_scan_bwd_tc_ref``).  ``--heads`` then times SSD's kernel at every
head group that divides H (the C entry's ``hg``) at the timed shapes and
at ``HEAD_SHAPES`` (zamba2-1.2b's heads in batched training microbatches),
in turns, beside the group ``ssd_scan.heads_a_block`` picks.  Prints one
JSON line per shape (ms per variant and round, errors, the bound), then
the card's name and power limit.  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import env  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssdk  # noqa: E402
from repro_torch.kernels import wkv6_scan as wkvk  # noqa: E402

CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/scan_bwd_variants"
SCANS = ("wkv6_scan_bwd", "ssd_scan_bwd")
# scan -> exact (old, new) edit that lets the float32 entry take bfloat16
EDITS = {
    "wkv6_scan_bwd": (
        "    err = dispatch_d<float>(p, D, duf, st);\n  else\n",
        "    err = dispatch_d<float>(p, D, duf, st);\n  else if (dtype == 1)\n"
        "    err = dispatch_d<__nv_bfloat16>(p, D, duf, st);\n  else\n"),
    "ssd_scan_bwd": (
        "    err = dispatch<float>(p, P, N, dB, dC, dAf, st);\n  else\n",
        "    err = dispatch<float>(p, P, N, dB, dC, dAf, st);\n"
        "  else if (dtype == 1)\n"
        "    err = dispatch<__nv_bfloat16>(p, P, N, dB, dC, dAf, st);\n"
        "  else\n"),
}
# the entries: (name, pointer args, int args)
ENTRIES = {
    ("wkv6_scan_bwd", "tc"): ("wkv6_scan_bwd_tc", 15, 4),
    ("wkv6_scan_bwd", "scalar"): ("wkv6_scan_bwd", 14, 5),
    ("ssd_scan_bwd", "tc"): ("ssd_scan_bwd_tc", 17, 6),
    ("ssd_scan_bwd", "scalar"): ("ssd_scan_bwd", 16, 6),
}


def _edit(text, edits, what):
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{what}: edit does not match the source once: "
                             f"{old!r}")
        text = text.replace(old, new)
    return text


def variant_sources(scan):
    """{variant: CUDA source} of one scan's backward."""
    base = (CSRC / f"{scan}.cu").read_text()
    return {"kernel": base, "scalar": _edit(base, [EDITS[scan]], scan)}


def build(sources):
    """{(scan, variant): library}, one nvcc each, all at once."""
    nvcc = env.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    OUT.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (OUT / header.name).write_bytes(header.read_bytes())
    procs = {}
    for key, text in sources.items():
        src = OUT / f"{key[0]}_{key[1]}.cu"
        src.write_text(text)
        procs[key] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(src.with_suffix(".so")),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc rc {proc.returncode}\n{log}")
        libs[key] = ctypes.CDLL(str(OUT / f"{key[0]}_{key[1]}.so"))
    return libs


def _entry(lib, scan, kind):
    name, n_ptr, n_int = ENTRIES[scan, kind]
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _f32(*shape, dev):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def calls(scan, args, dy, libs):
    """{variant: (call, its gradients, its scratch)} on preallocated
    outputs; the kernel at its bf16 entry with ``bwd_scratch``'s layout,
    the others at the float32 entry with PR 23's scratch.  The caller
    keeps the scratch alive while it calls: the launches see only
    pointers."""
    dev = dy.device
    stream = torch.cuda.current_stream().cuda_stream
    grads = [torch.empty_like(a) for a in args]
    B, S, H = args[0].shape[:3]
    nc = -(-S // 64)
    out = {}
    for (sc, variant), lib in libs.items():
        if sc != scan:
            continue
        kind = "tc" if variant == "kernel" else "scalar"
        fn = _entry(lib, scan, kind)
        g = [torch.empty_like(t) for t in grads]
        if scan == "wkv6_scan_bwd":
            D = args[0].shape[-1]
            if kind == "tc":
                scratch, ints = wkvk.bwd_scratch(args[0]), [B, S, H, D]
            else:
                scratch = (_f32(B, H, D, dev=dev),
                           _f32(B, H, nc, D, D, dev=dev),
                           _f32(B, H, 64 // wkvk.segment_steps(D), D, D,
                                dev=dev))
                ints = [B, S, H, D, 1]
        else:
            P, N = args[0].shape[-1], args[3].shape[-1]
            if kind == "tc":
                scratch = ssdk.bwd_scratch(args[0], args[3])
                ints = [B, S, H, P, N, ssdk.heads_a_block(B, S, H)]
            else:
                scratch = (_f32(B, H, dev=dev), _f32(B, S, H, N, dev=dev),
                           _f32(B, S, H, N, dev=dev),
                           _f32(B, H, nc, P, N, dev=dev),
                           _f32(B, H, 64 // ssdk.segment_steps(P, N), P, N,
                                dev=dev))
                ints = [B, S, H, P, N, 1]
        ptrs = [t.data_ptr() for t in (*args, dy, *g, *scratch)]

        def call(fn=fn, ptrs=ptrs, ints=ints, variant=variant):
            rc = fn(*ptrs, *ints, stream)
            if rc:
                raise RuntimeError(f"{scan} {variant}: launch failed ({rc})")
        out[variant] = (call, g, scratch)
    return out


# zamba2-1.2b's heads (64 of P 64, N 64) in batched training microbatches
# (the dry run's train_4k microbatch is 16 x 4096): (name, B, S)
HEAD_SHAPES = (("zamba2_train_16x512", 16, 512),
               ("zamba2_train_4x1024", 4, 1024),
               ("zamba2_train_16x4096", 16, 4096))


def head_groups(gen, dev, libs, rounds):
    """SSD's bf16 kernel at every head group that divides H, in turns, at
    the timed shapes and HEAD_SHAPES: one JSON line per shape with each
    group's ms a round, its gradients' largest rel against the first
    group's (the sums over heads run in another order), and the group
    ``heads_a_block`` picks."""
    dims = {shape: (B, S) for shape, B, S, *_ in cs.SSD_BWD_SHAPES
            if shape in cs.SSD_BWD_TIMED}
    dims.update((shape, (B, S)) for shape, B, S in HEAD_SHAPES)
    fn = _entry(libs["ssd_scan_bwd", "kernel"], "ssd_scan_bwd", "tc")
    stream = torch.cuda.current_stream().cuda_stream
    H, P, N = 64, 64, 64
    for shape, (B, S) in dims.items():
        xs = cs.ssd_inputs(gen, dev, B, S, H, P, N, "normal", torch.bfloat16)
        dy = torch.randn(xs[0].shape, generator=gen, device=dev).to(
            torch.bfloat16)
        grads = [torch.empty_like(t) for t in xs]
        groups = [hg for hg in range(1, H + 1) if H % hg == 0]
        calls, first = {}, None
        for hg in groups:
            scratch = ssdk.scratch_for(xs[0], xs[3], hg)
            ptrs = [t.data_ptr() for t in (*xs, dy, *grads, *scratch)]

            def call(ptrs=ptrs, hg=hg, scratch=scratch):
                if fn(*ptrs, B, S, H, P, N, hg, stream):
                    raise RuntimeError(f"ssd_scan_bwd hg {hg}: launch failed")
            calls[hg] = call
        row = {"kernel": "ssd_scan_bwd", "shape": shape, "B": B, "S": S,
               "heads_a_block": ssdk.heads_a_block(B, S, H),
               "ms": {hg: [] for hg in groups}, "rel_vs_first": {}}
        for r in range(rounds):
            for hg in groups if r % 2 == 0 else groups[::-1]:
                calls[hg]()
                torch.cuda.synchronize()
                if first is None:
                    first = [g.clone() for g in grads]
                row["rel_vs_first"][hg] = max(
                    cs._rel(a, b) for a, b in zip(grads, first))
                row["ms"][hg].append(cs.device_ms(calls[hg]))
        del calls, first, grads, xs, dy
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--heads", action="store_true",
                    help="also time SSD's kernel at every head group")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_bwd_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    libs = build({(scan, v): text for scan in SCANS
                  for v, text in variant_sources(scan).items()})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    for scan, shapes, timed, make, plain, mirror, work in (
            ("wkv6_scan_bwd", cs.WKV_BWD_SHAPES, cs.WKV_BWD_TIMED,
             cs.wkv_inputs, ref.wkv6_scan_bwd_ref, ref.wkv6_scan_bwd_tc_ref,
             cs.wkv_bwd_work),
            ("ssd_scan_bwd", cs.SSD_BWD_SHAPES, cs.SSD_BWD_TIMED,
             cs.ssd_inputs, ref.ssd_scan_bwd_ref, ref.ssd_scan_bwd_tc_ref,
             cs.ssd_bwd_work)):
        for shape, *dims, dt in shapes:
            if shape not in timed:
                continue
            xs = make(gen, dev, *dims, dt)
            dy = torch.randn(xs[0].shape, generator=gen, device=dev).to(dt)
            variants = calls(scan, xs, dy, libs)
            want = plain(*xs, dy, chunk=16)
            row = {"kernel": scan, "shape": shape,
                   "ms": {v: [] for v in variants}, "rel_err": {},
                   "tc_mirror_rel_err": None, **work(*xs, dy)}
            names = list(variants)
            for r in range(args.rounds):
                for name in names if r % 2 == 0 else names[::-1]:
                    call, grads, _ = variants[name]
                    call()
                    torch.cuda.synchronize()
                    row["rel_err"][name] = [
                        cs._rel(a, b) for a, b in zip(grads, want)]
                    row["ms"][name].append(cs.device_ms(call))
            row["tc_mirror_rel_err"] = [
                cs._rel(a, b) for a, b in
                zip(variants["kernel"][1], mirror(*xs, dy))]
            print(json.dumps(row), flush=True)
    if args.heads:
        head_groups(gen, dev, libs, args.rounds)
    print(env.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
