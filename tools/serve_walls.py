"""Wall seconds of ``chip_smoke.py``'s serve phase for some archs, from the
tree at ROOT (this repository, or a parent unpacked with ``git archive``
into a git-ignored directory), to compare two trees in one chip call.

    python3 tools/serve_walls.py ROOT ARCH [ARCH ...]

It builds ROOT's kernels, runs ``chip_smoke.phase_serve`` for each arch
(its checks included) and prints one line ``AB {"root": ..., arch:
seconds, ...}``.  Run the trees in turns in one call (parent, change,
change, parent): walls swing between calls, not within one.  Needs a card.
"""
import json
import os
import sys
import time


def main(argv) -> int:
    root = os.path.abspath(argv[0])
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    dev = cs.env.device("cuda")
    cs.phase_build()
    out = {"root": argv[0]}
    for arch in argv[1:]:
        t0 = time.monotonic()
        cs.phase_serve(dev, arch)
        out[arch] = time.monotonic() - t0
        cs._free()
    print("AB", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
