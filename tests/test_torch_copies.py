"""The port's copies of the reference's host modules stay copies.

Each module below imports no JAX in the reference, and the port keeps its
own copy of it.  Its source must equal the reference's once the package
``repro`` is renamed to ``repro_torch``, apart from the differences listed
here, each as (the renamed reference's text, the port's text, why).  Every
listed difference must still be there, so the list cannot go stale.  In
``launch/serve.py`` and ``launch/quickstart.py``, which hold the port's own
code beside the copies, each copied function is compared on its own."""
import ast
import re
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

MODULES = [f"core/{m}.py" for m in (
    "bundler", "dag", "engine", "handlers", "hierarchy", "jsonstore",
    "queue", "resilience", "runtime", "spec", "wirecodec", "worker",
    "hashring", "netbroker", "shardbroker", "shmring", "autoscale", "chaos",
    "cascade", "__init__")] + ["data/pipeline.py", "serve/gateway.py"]

DEVICE = "the port runs its ensembles on the card unless the CPU is asked for"
HISTORY = "the port's copies cite no change request of the reference's history"
ALLOWED = {
    "core/shardbroker.py": [
        ("The epoch fences replica failover\n(PR 7), and",
         "The epoch fences replica failover,\nand", HISTORY),
    ],
    "core/hashring.py": [
        ("fenced exactly like the PR 7 failover epochs.",
         "fenced exactly like the replica failover epochs.", HISTORY),
    ],
    "core/__init__.py": [
        ("# Merlin's contribution in JAX-native form: hierarchical task "
         "generation,",
         "# Merlin's contribution, ported to PyTorch: hierarchical task "
         "generation,", "the package is not JAX"),
        ("# parameter x sample DAG layering, device-fused ensemble execution,"
         "\n# bundling/aggregation, and crawl-resubmit resilience.",
         "# parameter x sample DAG layering, device-fused ensemble execution "
         "(one\n# CUDA graph a bucket), bundling/aggregation, and "
         "crawl-resubmit resilience.", "the port fuses bundles into graphs"),
    ],
    "core/shmring.py": [
        ("(repro_torch/env.py records\n# the host; these read the "
         "environment once at import.)",
         "(These read the environment\n# once at import.)",
         "the port's env.py records no shared-memory settings"),
    ],
    "core/cascade.py": [
        ("import numpy as np\n\nfrom repro_torch.core.bundler",
         "import numpy as np\n\nfrom repro_torch import env\n"
         "from repro_torch.core.bundler", DEVICE),
        ("                 seed: int = 0):\n        \"\"\"observed: metro -> "
         "daily case curve to calibrate against.\"\"\"\n        self.rt = "
         "runtime\n",
         "                 seed: int = 0, device=None):\n        \"\"\"observed:"
         " metro -> daily case curve to calibrate against.\n        The "
         "ensembles run on ``device``: ``cuda`` unless ``cpu`` is asked\n"
         "        for (the port's one addition, as in ``OptimizationLoop``)."
         "\"\"\"\n        self.rt = runtime\n        self.device = "
         "env.device(device)\n", DEVICE),
        ("reuses XLA programs\n        ex = EnsembleExecutor(self.sim, "
         "self._bundler(\"calib\", metro))\n",
         "reuses the programs\n        ex = EnsembleExecutor(self.sim, "
         "self._bundler(\"calib\", metro),\n                              "
         "device=self.device)\n", DEVICE),
        ("        ex = EnsembleExecutor(self.sim, self._bundler(f\"fc_{scen}\","
         " metro))\n",
         "        ex = EnsembleExecutor(self.sim, self._bundler(f\"fc_{scen}\","
         " metro),\n                              device=self.device)\n",
         DEVICE),
    ],
}

SERVE_FUNCTIONS = ["broker_serve_main", "status_snapshot", "_render_status",
                   "watch_rates", "_render_ring", "merlin_status_main",
                   "_render_plan", "merlin_scale_main", "merlin_dlq_main",
                   "merlin_validate_main", "merlin_serve_main", "main"]
CONFIGURE = ("the port has no JAX runtime settings to apply "
             "(repro.env.configure)")
ALLOWED_FUNCTIONS = {
    ("launch/serve.py", "broker_serve_main"): [
        ("    from repro_torch import env as repro_env\n    "
         "repro_env.configure()\n\n", "", CONFIGURE),
    ],
    ("launch/serve.py", "merlin_serve_main"): [
        ("    args = ap.parse_args(argv)\n\n    from repro_torch import env "
         "as repro_env\n    repro_env.configure()\n",
         "    ap.add_argument(\"--device\", choices=(\"cuda\", \"cpu\"), "
         "default=\"cuda\",\n                    help=\"where the snapshot "
         "trains and predicts\")\n    args = ap.parse_args(argv)\n\n    "
         "from repro_torch import env\n    device = env.device(args.device)"
         "  # raises before any work without a card\n",
         "merlin-serve trains and predicts on the card unless --device cpu; "
         + CONFIGURE),
        ("hidden=args.hidden, steps=args.steps)\n",
         "hidden=args.hidden, steps=args.steps,\n"
         "                                 device=device)\n", DEVICE),
        ("\"study\": args.study,\n",
         "\"study\": args.study,\n                      \"device\": "
         "env.device_name(device),\n", "the listening event names the "
         "device"),
    ],
    ("launch/quickstart.py", "spawn_broker_server"): [
        ("\"PYTHONPATH\": \"src\" + os.pathsep",
         "\"PYTHONPATH\": _SRC + os.pathsep",
         "the package's own source tree, not one relative to the working "
         "directory"),
    ],
}


def _renamed(path: Path) -> str:
    return re.sub(r"\brepro\b", "repro_torch", path.read_text())


def _apply(text: str, allowed, where: str) -> str:
    for old, new, reason in allowed:
        assert reason
        assert text.count(old) == 1, f"{where}: allowed difference " \
                                     f"{old[:60]!r} is not there once"
        text = text.replace(old, new)
    return text


@pytest.mark.parametrize("module", MODULES)
def test_module_is_a_copy(module):
    want = _apply(_renamed(SRC / "repro" / module), ALLOWED.get(module, ()),
                  module)
    assert (SRC / "repro_torch" / module).read_text() == want


def _functions(text: str):
    tree = ast.parse(text)
    return {node.name: ast.get_source_segment(text, node)
            for node in tree.body if isinstance(node, ast.FunctionDef)}


@pytest.mark.parametrize("where,name", [
    ("launch/serve.py", f) for f in SERVE_FUNCTIONS] + [
    ("launch/quickstart.py", "spawn_broker_server"),
    ("configs/registry.py", "arch_rules")])
def test_function_is_a_copy(where, name):
    ref_file = {"launch/quickstart.py": SRC.parent / "examples" /
                "quickstart.py"}.get(where, SRC / "repro" / where)
    want = _apply(_functions(_renamed(ref_file))[name],
                  ALLOWED_FUNCTIONS.get((where, name), ()), f"{where}:{name}")
    assert _functions((SRC / "repro_torch" / where).read_text())[name] == want
