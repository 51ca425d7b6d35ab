"""The benchmark's manifest (``BENCHMARK.json``) and the files it names.

A cell (an entry of ``workloads``) is found by its name; its
configuration by the ``configs`` entry's ``file``; its traffic mix at
``portbench/traffic/<traffic>.json``; the limits of the numbers that
decide ``correct`` at ``portbench/limits/<cell>.json``; a per-layer
metric's reader at ``portbench/metrics/<metric>.py``.  Adding a cell, a
configuration or a metric is adding files and manifest entries: nothing
here names one.

A cell reports the end-to-end metrics that list it under ``workloads``
(or list no workloads), and the per-layer metrics that list it, or, with
no ``workloads`` key, whose ``moves`` metric it reports.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List

ROOT = Path(__file__).resolve().parents[2]
HERE = "portbench"


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, man: dict = None) -> Cell:
    """The cell ``name`` of the manifest at ``root``, or of ``man`` (a
    manifest's object, its files still under ``root``)."""
    man = man or load(root)
    entries = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; the manifest has {sorted(entries)}")
    w = entries[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    e2e = [m for m in man["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if name in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in reported)]
    return Cell(name=name, entry=w, config=_json(root / conf["file"]),
                traffic=_json(root / HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_json(root / HERE / "limits" / f"{name}.json")["numbers"],
                end_to_end=e2e, per_layer=layer)


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The ``read(ctx)`` of ``portbench/metrics/<metric>.py``."""
    path = root / HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
