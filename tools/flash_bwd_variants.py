#!/usr/bin/env python3
"""The bf16 flash backward's design choices, timed in turns on one card at
the backward's shapes in ``chip_smoke.py`` (jag-surrogate's training
shapes, zamba2's 512 prefill, GQA, window + softcap, D 128 with GQA, and
the encoder archs' training shapes: whisper's encoder and cross-attention,
llama-vision's cross-attention).

    python3 tools/flash_bwd_variants.py [--parent DIR/flash_attention_bwd.cu]
                                        [--rounds 2]

``kernel`` is ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` as it
stands, which picks its warp split at launch.  Each other variant is that
source with one choice changed by an exact edit (``VARIANTS``): the split
forced to 1, 2 or 4 warps a 16-row slice, or a launch bound of 2 blocks an
SM at every head dim.  Every variant computes the same function, so each is
also held to ``ref.flash_attention_bwd_tc_ref``.  ``--parent`` adds another
``flash_attention_bwd.cu`` with the same C entry, e.g. the parent commit's
unpacked beside the checkout with ``git archive``.  Every variant is built
with the repo's nvcc flags into ``build/flash_bwd_variants/`` and timed with
``chip_smoke.device_ms``, the variants in turns, ``--rounds`` times each
way.  Prints one JSON line per shape (ms per variant and round, each
variant's error against the mirror, scaled_dot_product_attention's
backward), then the card's name and power limit.  Needs a card.
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
from repro_torch.kernels import flash_attention as fak  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
OUT = ROOT / "build/flash_bwd_variants"
SPLIT = "      p.split = split;\n"
# variant -> exact (old, new) edits of SOURCE, each old string found once
VARIANTS = {
    "split1": [(SPLIT, SPLIT + "  p.split = 1;\n")],
    "split2": [(SPLIT, SPLIT + "  p.split = 2;\n")],
    "split4": [(SPLIT, SPLIT + "  p.split = 4;\n")],
    "two_blocks_an_sm": [("constexpr int kMinBlocks = D <= 64 ? 3 : 2;",
                          "constexpr int kMinBlocks = 2;")],
}
SHAPES = ("jag_train_128", "jag_bundles_8", "zamba2_512", "D128_gqa",
          "gqa_8_2", "window64_softcap30") + cs.BWD_ENCDEC


def variant_sources(parent=None):
    """{variant: CUDA source}: the kernel, its variants and the parent."""
    base = SOURCE.read_text()
    out = {"kernel": base}
    for name, edits in VARIANTS.items():
        s = base
        for old, new in edits:
            if s.count(old) != 1:
                raise ValueError(f"{name}: edit does not match {SOURCE.name} "
                                 f"once: {old!r}")
            s = s.replace(old, new)
        out[name] = s
    if parent is not None:
        out["parent"] = Path(parent).read_text()
    return out


def build(sources):
    nvcc = env.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    OUT.mkdir(parents=True, exist_ok=True)
    for header in SOURCE.parent.glob("*.cuh"):
        (OUT / header.name).write_bytes(header.read_bytes())
    procs = {}
    for name, text in sources.items():
        src = OUT / f"bwd_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / f"libbwd_{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc rc {proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(OUT / f"libbwd_{name}.so"))
        lib.flash_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.flash_attention_bwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another flash_attention_bwd.cu to time")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    libs = build(variant_sources(args.parent))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    names = list(libs)
    for (shape, B, S, T, H, KV, D, dt, causal, window,
         softcap) in cs.BWD_SHAPES:
        if shape not in SHAPES:
            continue
        q, do = (torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, T, KV, D, generator=gen, device=dev).to(dt)
                for _ in range(2))
        kw = dict(causal=causal, window=window, softcap_val=softcap)
        out, lse = fak.flash_attention_lse(q, k, v, **kw)
        mirror = ref.flash_attention_bwd_tc_ref(q, k, v, out, do, lse, **kw)
        grads = [torch.empty_like(x) for x in (q, k, v)]
        delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        row = {"shape": shape, "ms": {n: [] for n in names}, "rel_err": {}}
        for r in range(args.rounds):
            for name in names if r % 2 == 0 else names[::-1]:

                def call(lib=libs[name]):
                    rc = lib.flash_attention_bwd(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), *(g.data_ptr() for g in grads),
                        B, S, T, H, KV, D, 1, 1.0 / D ** 0.5,
                        float(softcap or 0.0), int(causal), int(window or 0),
                        torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: launch failed ({rc})")
                call()
                torch.cuda.synchronize()
                row["rel_err"][name] = max(
                    cs._rel(a, b) for a, b in zip(grads, mirror))
                row["ms"][name].append(cs.device_ms(call))
        row["library_ms"] = cs.sdpa_backward(q, k, v, do, causal,
                                             1.0 / D ** 0.5)["library_ms"]
        print(json.dumps(row), flush=True)
    print(env.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
