"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, what each cell reports, and the files each entry needs; and the
same of the manifest with the staged cells' entries added
(``tiny.with_staged``)."""
import json
import re

import pytest

from portbench.lib import manifest
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
# keys that name a width (never cut); depth and vocabulary keys may be
WIDTHS = re.compile(r"(hidden_size|intermediate_size|_dim$|_rank$|head_size|"
                    r"headdim|^n_embd$|^dim_ffn$|expand|d_state|latent|proj|"
                    r"experts_per_tok|top_k)")


@pytest.fixture(scope="module", params=["committed", "staged"])
def man(request):
    return manifest.load() if request.param == "committed" else \
        tiny.with_staged()


def test_top_level_keys_and_command(man):
    assert set(man) == TOP
    assert man["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert man["command"][1].startswith(man["paths"][0] + "/")
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man)) <= 64 * 1024


def test_a_full_check_fits_its_time(man):
    cells = 24  # later PRs may add cells up to the limit
    runs = 2 + 14 * cells
    total = runs * (man["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entries(man):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in man[group]]
        assert len(names) == len(set(names)), group
        for e in man[group]:
            assert set(e) - {"workloads"} == want, (group, e["name"])
            assert NAME.match(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
                    assert "\t" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
    metric_names = [e["name"] for e in man["end_to_end"] + man["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    assert 1 <= len(man["configs"]) <= 24 and 1 <= len(man["workloads"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16 and 1 <= len(man["per_layer"]) <= 128


def test_configs(man):
    used = {w["config"] for w in man["workloads"]}
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))
    for c in man["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in man["paths"]))
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTHS.search(k), k
        conf = json.load(open(manifest.ROOT / c["file"]))
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]


def test_workloads(man):
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)
    for w in man["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        manifest.cell(w["name"], man=man)  # its config, traffic and limits load


def test_end_to_end_bounds(man):
    names = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in names and "workloads" not in names["setup_s"]
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_enough(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for w in man["workloads"]:
        c = manifest.cell(w["name"], man=man)
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", ()):
            assert cell in {w["name"] for w in man["workloads"]}


def test_layers_named_alike(man):
    """Metrics of one layer give the same layer name; rooflines and MFU
    shares are in %."""
    for m in man["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    kernels = {m["layer"] for m in man["per_layer"]
               if m["name"].split(".")[0].endswith("_roofline")}
    assert len(kernels) == 1


def test_every_per_layer_metric_has_a_reader(man):
    for m in man["per_layer"]:
        assert callable(manifest.reader(m["name"]))
