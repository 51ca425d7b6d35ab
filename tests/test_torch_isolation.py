"""The PyTorch port stands alone: importing every ``repro_torch`` module and
``chip_smoke.py`` loads neither JAX nor any module of the ``repro`` package,
and its CUDA entry points raise when no card is visible and the CPU was not
asked for, while the host-only CLIs (``broker-serve``, ``merlin-validate``,
``merlin-status``) run without one.  Runs in a fresh interpreter, so nothing
the test process already imported can hide a leak."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
mods = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in mods:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)

import contextlib, io, os, tempfile
import torch
from repro_torch import env
from repro_torch.launch.serve import (broker_serve_main, llm_serve_main,
                                      merlin_serve_main, merlin_status_main,
                                      merlin_validate_main)
from repro_torch.launch import (covid_calibration, icf_ensemble,
                                optimization_loop, quickstart)
study = tempfile.mkdtemp()
raised = {}
for name, call in [("env.device", lambda: env.device()),
                   ("env.device_cuda", lambda: env.device("cuda")),
                   ("llm_serve_main", lambda: llm_serve_main(
                       ["--arch", "jag-surrogate", "--prompt-len", "8",
                        "--new-tokens", "2"])),
                   ("llm_serve_main_rwkv6", lambda: llm_serve_main(
                       ["--arch", "rwkv6-3b", "--prompt-len", "8",
                        "--new-tokens", "2"])),
                   ("quickstart", lambda: quickstart.main(
                       ["--samples", "16"])),
                   ("quickstart_two_process", lambda: quickstart.main(
                       ["--samples", "16", "--two-process"])),
                   ("merlin_serve_main", lambda: merlin_serve_main(
                       ["--study", study, "--port-file",
                        os.path.join(study, "port")])),
                   ("covid_calibration", lambda: covid_calibration.main([])),
                   ("optimization_loop", lambda: optimization_loop.main([])),
                   ("icf_ensemble", lambda: icf_ensemble.main(["16"]))]:
    try:
        call()
        raised[name] = None
    except RuntimeError as e:
        raised[name] = str(e)
host = {}
out = io.StringIO()
with contextlib.redirect_stdout(out):
    try:
        broker_serve_main(["--help"])
    except SystemExit as e:
        host["broker_serve_help"] = e.code
    host["merlin_validate"] = merlin_validate_main(sys.argv[2:])
    host["merlin_status"] = merlin_status_main(["--broker", "mem://",
                                                "--json"])
host["stdout"] = out.getvalue()
leaks = sorted(m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "jaxlib"))
               or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": mods, "leaks": leaks, "raised": raised,
                  "host": host,
                  "cuda": torch.cuda.is_available(),
                  "cpu_ok": str(env.device("cpu"))}))
"""


def _env():
    e = dict(os.environ)
    e["PYTHONPATH"] = str(ROOT / "src")
    return e


def test_port_imports_no_jax_and_no_reference():
    import json
    specs = sorted(str(p) for p in (ROOT / "examples" / "specs").glob("*.yaml"))
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT / "chip_smoke.py"),
                          *specs],
                         capture_output=True, text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaks"] == []
    for mod in ("repro_torch.env", "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.wkv6_scan", "repro_torch.kernels.ssd_scan",
                "repro_torch.models.lm", "repro_torch.models.rwkv",
                "repro_torch.models.ssm", "repro_torch.serve.engine",
                "repro_torch.launch.serve", "repro_torch.convert",
                "repro_torch.core.queue", "repro_torch.core.runtime",
                "repro_torch.core.engine", "repro_torch.core.worker",
                "repro_torch.core.ensemble", "repro_torch.core.active",
                "repro_torch.sim.jag", "repro_torch.sim.epidemic",
                "repro_torch.sim.nullsim", "repro_torch.data.pipeline",
                "repro_torch.launch.quickstart",
                "repro_torch.core.hashring", "repro_torch.core.netbroker",
                "repro_torch.core.shardbroker", "repro_torch.core.shmring",
                "repro_torch.core.autoscale", "repro_torch.core.chaos",
                "repro_torch.core.cascade", "repro_torch.serve.gateway",
                "repro_torch.launch.covid_calibration",
                "repro_torch.launch.optimization_loop",
                "repro_torch.launch.icf_ensemble"):
        assert mod in res["modules"]
    host = res["host"]
    assert host["broker_serve_help"] == 0 and "--join" in host["stdout"]
    assert host["merlin_validate"] == 0
    assert host["stdout"].count("OK   ") == len(specs) == 3
    assert host["merlin_status"] is None and '"totals"' in host["stdout"]
    assert res["cpu_ok"] == "cpu"
    if not res["cuda"]:
        for name, msg in res["raised"].items():
            assert msg and "no CUDA device" in msg, name


def test_chip_smoke_fails_without_a_card():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the script runs its smoke phases")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=_env(), timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
