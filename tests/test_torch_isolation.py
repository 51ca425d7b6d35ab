"""The PyTorch port stands alone: importing every ``repro_torch`` module and
``chip_smoke.py`` loads neither JAX nor any module of the ``repro`` package,
and its CUDA entry points raise when no card is visible and the CPU was not
asked for.  Runs in a fresh interpreter, so nothing the test process already
imported can hide a leak."""
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
leaks = sorted(m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "jaxlib"))
               or m == "repro" or m.startswith("repro."))

import torch
from repro_torch import env
from repro_torch.launch.serve import llm_serve_main
raised = {}
for name, call in [("env.device", lambda: env.device()),
                   ("env.device_cuda", lambda: env.device("cuda")),
                   ("llm_serve_main", lambda: llm_serve_main(
                       ["--arch", "jag-surrogate", "--prompt-len", "8",
                        "--new-tokens", "2"])),
                   ("llm_serve_main_rwkv6", lambda: llm_serve_main(
                       ["--arch", "rwkv6-3b", "--prompt-len", "8",
                        "--new-tokens", "2"]))]:
    try:
        call()
        raised[name] = None
    except RuntimeError as e:
        raised[name] = str(e)
print(json.dumps({"modules": mods, "leaks": leaks, "raised": raised,
                  "cuda": torch.cuda.is_available(),
                  "cpu_ok": str(env.device("cpu"))}))
"""


def _env():
    e = dict(os.environ)
    e["PYTHONPATH"] = str(ROOT / "src")
    return e


def test_port_imports_no_jax_and_no_reference():
    import json
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaks"] == []
    for mod in ("repro_torch.env", "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.wkv6_scan", "repro_torch.kernels.ssd_scan",
                "repro_torch.models.lm", "repro_torch.models.rwkv",
                "repro_torch.models.ssm", "repro_torch.serve.engine",
                "repro_torch.launch.serve", "repro_torch.convert"):
        assert mod in res["modules"]
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
