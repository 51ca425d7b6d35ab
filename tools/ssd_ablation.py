#!/usr/bin/env python3
"""Where the bf16 SSD kernel's time goes: its phases switched off one at a
time, timed in turns on one card at zamba2-1.2b's prefill shapes (B=4, H=64,
P=N=64; S = 512, 200, 32).

    python3 tools/ssd_ablation.py [--parent DIR/ssd_scan.cu] [--rounds 2]

``kernel`` is ``src/repro_torch/kernels/csrc/ssd_scan.cu`` as it stands.
Each other variant is that source with one phase removed by an exact edit
(``ABLATIONS``): its output is then wrong, and only its time is read.
``--parent`` adds another ``ssd_scan.cu`` with the same C entry, e.g. the
parent commit's unpacked beside the checkout with ``git archive``.  Every
variant is built with the repo's nvcc flags into ``build/ssd_ablation/``
(only the P = N = 64 instance where the source's dispatch allows it) and
timed with ``chip_smoke.device_ms``, the variants in turns, ``--rounds``
times each way.  Prints one JSON line per shape (ms per variant and round,
and the error of ``kernel`` and ``parent`` against the chunked plain
version), then the card's name and power limit.  Needs a card.
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

SOURCE = ROOT / "src/repro_torch/kernels/csrc/ssd_scan.cu"
OUT = ROOT / "build/ssd_ablation"
CHT = ("    for (int kc = 0; kc < N / 16; ++kc) {\n      uint32_t a[4];\n",
       "    for (int kc = 0; kc < 0; ++kc) {\n      uint32_t a[4];\n")
INTRA = ("      if (kk > rw) break;             // above the diagonal: W = 0\n",
         "      if (kk >= 0) break;\n")
STATE = ("    for (int kk = 0; kk < 4; ++kk) {  // rows s = 16 kk .. 16 kk + 15\n",
         "    for (int kk = 0; kk < 0; ++kk) {\n")
Y_OUT = ("    for (int i = tid; i < n * (P / 8); i += NT) {\n",
         "    for (int i = tid; i < 0; i += NT) {\n")
COPIES = [("    for (int i = tid; i < L * CX; i += NT) {\n",
           "    for (int i = tid; i < 0; i += NT) {\n"),
          ("    for (int i = tid; i < L * CN; i += NT) {\n",
           "    for (int i = tid; i < 0; i += NT) {\n")]
# variant -> exact (old, new) edits of SOURCE, each old string found once
ABLATIONS = {
    "no_cht": [CHT],                 # y's C h^T products
    "no_intra": [INTRA],             # C B^T, W and W x
    "no_state": [STATE],             # the state update's products
    "no_products": [CHT, INTRA, STATE],
    "no_products_y_out": [CHT, INTRA, STATE, Y_OUT],  # and y's stores
    "skeleton": [CHT, INTRA, STATE, Y_OUT] + COPIES,  # and x, B, C copies
}
# the dispatch of every instance other than P = N = 64, where present
OTHER_INSTANCES = [
    "    case 16: err = dispatch_n<16>(p, N, dtype, st); break;\n",
    "    case 32: err = dispatch_n<32>(p, N, dtype, st); break;\n",
    "    case 16: return launch<P, 16>(p, dtype, stream);\n",
    "    case 32: return launch<P, 32>(p, dtype, stream);\n",
    "    case 128: return launch<P, 128>(p, dtype, stream);\n",
]


def variant_sources(parent=None):
    """{variant: CUDA source}: the kernel, its ablations and the parent."""
    base = SOURCE.read_text()
    out = {"kernel": base}
    for name, edits in ABLATIONS.items():
        s = base
        for old, new in edits:
            if s.count(old) != 1:
                raise ValueError(f"{name}: edit does not match {SOURCE.name} "
                                 f"once: {old!r}")
            s = s.replace(old, new)
        out[name] = s
    if parent is not None:
        out["parent"] = Path(parent).read_text()
    for name, s in out.items():
        for line in OTHER_INSTANCES:
            s = s.replace(line, "")
        out[name] = s
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
        src = OUT / f"ssd_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / f"libssd_{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc rc {proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(OUT / f"libssd_{name}.so"))
        lib.ssd_scan_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.ssd_scan_fwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another ssd_scan.cu to time beside")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_ablation: no CUDA device is visible", file=sys.stderr)
        return 2
    libs = build(variant_sources(args.parent))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    names = list(libs)
    for S, chunk in ((512, 256), (200, 200), (32, 32)):
        x, dt, A, Bm, Cm = cs.ssd_inputs(gen, dev, 4, S, 64, 64, 64, "normal",
                                         torch.bfloat16)
        want = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk).float()
        row = {"S": S, "ms": {n: [] for n in names}, "rel_err": {}}
        for r in range(args.rounds):
            for name in names if r % 2 == 0 else names[::-1]:
                y = torch.empty_like(x)

                def call(lib=libs[name]):
                    rc = lib.ssd_scan_fwd(
                        x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), 4, S, 64,
                        64, 64, 1, torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: launch failed ({rc})")
                call()
                torch.cuda.synchronize()
                if name in ("kernel", "parent"):
                    row["rel_err"][name] = float(
                        (y.float() - want).abs().max() / want.abs().max())
                row["ms"][name].append(cs.device_ms(call))
        print(json.dumps(row), flush=True)
    print(env.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
