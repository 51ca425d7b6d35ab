"""A new cell, traffic mix, configuration and per-layer metric come from
files alone: a copy of the benchmark gains them by new files and new
manifest entries, no existing file of the harness changes, and the new
cell runs (at a size the CPU holds) and reports the new metric's reader's
number."""
import hashlib
import json
import shutil
import time

from portbench.lib import manifest, runner
from portbench.tests import tiny

NEW_READER = '''"""Device ms a training step in matrix products."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return 1e3 * ctx.trace.group_seconds("gemm") / ctx.steps
'''


def _hashes(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_need_no_edit(tmp_path):
    shutil.copytree(manifest.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _hashes(tmp_path)

    pb = tmp_path / "portbench"
    traffic = json.loads((pb / "traffic" / "train-4k.json").read_text())
    traffic.update(rows=32, seq_len=2048,
                   why="twice the rows at half the length")
    (pb / "traffic" / "train-2k.json").write_text(json.dumps(traffic))
    config = json.loads((pb / "configs" / "rwkv6-3b.json").read_text())
    config["name"] = "rwkv6-3b-8l"
    config["model"]["n_repeat"] = 8
    config["port"]["overrides"].update(n_layers=8, n_repeat=8)
    (pb / "configs" / "rwkv6-3b-8l.json").write_text(json.dumps(config))
    (pb / "limits" / "rwkv6-3b-8l.train-2k.json").write_text(
        (pb / "limits" / "rwkv6-3b.train-4k.json").read_text())
    (pb / "metrics" / "gemm_ms.train.py").write_text(NEW_READER)
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append(dict(man["configs"][1], name="rwkv6-3b-8l",
                               file="portbench/configs/rwkv6-3b-8l.json"))
    man["workloads"].append({"name": "rwkv6-3b-8l.train-2k",
                             "config": "rwkv6-3b-8l", "traffic": "train-2k",
                             "chips": 1, "why": "a test's cell"})
    man["end_to_end"][0]["workloads"].append("rwkv6-3b-8l.train-2k")
    man["per_layer"].append({"name": "gemm_ms.train", "unit": "ms",
                             "better": "lower", "source": "device_trace",
                             "layer": "kernels", "moves": "train_tokens_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    after = _hashes(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before

    c = manifest.cell("rwkv6-3b-8l.train-2k", tmp_path)
    assert c.traffic["seq_len"] == 2048 and c.config["model"]["n_repeat"] == 8
    assert [m["name"] for m in c.end_to_end] == ["train_tokens_per_s", "setup_s"]
    assert "gemm_ms.train" in [m["name"] for m in c.per_layer]
    small = tiny.cell("rwkv6-3b-8l.train-2k", root=tmp_path)
    r = runner.run_cell(small.name, 3, 0.1, False, "cpu", time.monotonic(),
                        root=tmp_path, cell=small)
    assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert r["correct"]
    r = runner.run_cell(small.name, 3, 0.1, True, "cpu", time.monotonic(),
                        root=tmp_path, cell=small)
    # the new reader is found and read (no device events on the CPU)
    assert r["metrics"] == {"gemm_ms.train": {"value": 0.0, "unit": "ms"}}
