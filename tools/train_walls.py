"""Step walls of ``chip_smoke.py``'s scan-arch training runs for some archs,
from the tree at ROOT (this repository, or a parent unpacked with ``git
archive`` into a git-ignored directory), to compare two trees in one chip
call.

    python3 tools/train_walls.py ROOT ARCH [ARCH ...]

It builds ROOT's kernels, draws the quickstart study's bundles on the CPU
and runs ``python -m repro_torch.launch.train`` for each arch as
``chip_smoke.phase_train_scan_archs`` does (``SCAN_TRAIN``'s depth and
batch, ``SCAN_TRAIN_STEPS`` steps, exact launch counts), and prints one
line ``AB {"root": ..., arch: {"step_ms": [...], "median_ms": ...}, ...}``
with every step's wall after the first.  Run the trees in turns in one
call (parent, change, change, parent): walls swing between calls, not
within one.  Needs a card.
"""
import json
import os
import statistics
import sys
import tempfile


def main(argv) -> int:
    root = os.path.abspath(argv[0])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    cs.phase_build()
    _, data, _ = cs.quickstart.run_study(torch.device("cpu"),
                                         samples=cs.MERLIN_SAMPLES)
    out = {"root": argv[0]}
    runs = {arch: (repeats, batch) for arch, repeats, batch in cs.SCAN_TRAIN}
    with tempfile.TemporaryDirectory() as tmp:
        study = cs._write_study(data, os.path.join(tmp, "study"))
        for arch in argv[1:]:
            repeats, batch = runs[arch]
            cfg = cs._cut(cs.registry.get_config(arch), repeats)
            args = ["--arch", arch, "--batch", str(batch), "--data", study,
                    "--steps", str(cs.SCAN_TRAIN_STEPS), "--ckpt-every", "0",
                    "--workdir", os.path.join(tmp, arch)]
            if repeats is not None:
                args += ["--repeats", str(repeats)]
            _, tr, _ = cs._train_run(
                f"{arch}_walls", args, batch * cs.RECORD_SEQ,
                cs._scan_train_launches(cfg, cs.SCAN_TRAIN_STEPS))
            dts = [1e3 * h["dt"] for h in tr.history[1:]]
            out[arch] = {"step_ms": dts, "median_ms": statistics.median(dts)}
            del tr
            cs._free()
    print("AB", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
