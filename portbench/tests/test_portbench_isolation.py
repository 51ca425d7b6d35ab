"""Nothing the benchmark runs imports JAX or the JAX package, and nothing
reads the JAX package's benchmarks: in a fresh interpreter the harness,
the reference and every metric reader are imported and a run of each cell
is driven at a size the CPU holds, under an audit hook that records every
file opened.  Top-level module names are compared whole (the port's name
begins with the JAX package's).  The reference, with every layer kind's
module, also imports nothing of the port."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = r"""
import json, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and args and isinstance(args[0], (str, bytes)) else None)
sys.path[:0] = [ROOT, ROOT + "/src"]
import portbench.reference.lm, portbench.reference.train, portbench.layers
portbench.layers.kernels()  # imports every layer kind's module
ref_only = sorted({m.split(".")[0] for m in sys.modules})
import time
from portbench.lib import manifest, runner
from portbench.tests import tiny
man = tiny.with_staged()  # the staged cells too
for w in man["workloads"]:
    runner.run_cell(w["name"], 5, 0.1, False, "cpu", time.monotonic(),
                    cell=tiny.cell(w["name"]))
for m in man["per_layer"]:
    manifest.reader(m["name"])
print(json.dumps({"ref_only": ref_only,
                  "modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "opened": opened}))
"""


def test_no_jax_no_jax_package_no_benchmarks_folder():
    out = subprocess.run(
        [sys.executable, "-c", f"ROOT = {str(ROOT)!r}\n" + PROBE],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert not FORBIDDEN & set(seen["modules"])
    assert "repro_torch" in seen["modules"]  # the run did drive the port
    assert not (FORBIDDEN | {"repro_torch"}) & set(seen["ref_only"])
    bad = [p for p in seen["opened"]
           if "/benchmarks/" in p or Path(p).name.startswith("BENCH_")]
    assert not bad
