"""One run of one cell: the traffic kind's code, then the cell's metrics
(the end-to-end ones, or with ``trace`` the per-layer ones from their
readers), the device, and the numbers that decide ``correct`` beside their
limits."""
from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

import torch

from portbench.lib import compare, manifest


def log(tag: str, obj) -> None:
    print(f"[portbench] {tag} {json.dumps(obj)}", file=sys.stderr, flush=True)


def device_info(device, chips: int, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips, "memory_peak_bytes": peak}
    return {"platform": dev.type, "kind": dev.type, "count": chips,
            "memory_peak_bytes": peak}


def quiet(tag: str, obj) -> None:
    """The log of a rank other than 0: nothing."""


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: Path = manifest.ROOT, cell=None,
             group=None) -> dict:
    """The result line's object.  ``cell`` (a ``manifest.Cell``) replaces
    the manifest's, as the harness's tests do to run at a small size.
    ``group`` (``ranks.Group``): this process is one rank of a cell on
    several cards; a rank other than 0 returns None."""
    c = cell or manifest.cell(name, root)
    kind = importlib.import_module(f"portbench.kinds.{c.traffic['kind']}")
    if group is None:
        out = kind.run(c, seed, seconds, trace, device, t_start, log)
    else:
        out = kind.run(c, seed, seconds, trace, device, t_start,
                       log if group.rank == 0 else quiet, group=group)
        if group.rank != 0:
            return None
    metrics = {}
    if trace:
        for m in c.per_layer:
            value = manifest.reader(m["name"], root)(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in c.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    correct, checks = compare.decide(out["numbers"], c.limits)
    log("numbers", out["numbers"])
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info(device, c.entry["chips"],
                                    out["memory_peak_bytes"])}
    if trace:
        tr = out["trace"]
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result
