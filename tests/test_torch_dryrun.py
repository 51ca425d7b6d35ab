"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

* The reference's HLO parsers, ported as pure helpers, pass the
  reference's own cases (``tests/test_dryrun.py``).
* ``python -m repro_torch.launch.dryrun --arch jag-surrogate --shape
  train_4k`` runs one cell on a 256-rank fake group in a subprocess (no
  fake process group may leak into a test worker) and reports FLOPs,
  saved bytes and the two-probe decomposition.
* For every arch and applicable shape on both production meshes, the
  bytes each device holds for the cell's arguments (``lower_cell``:
  parameters, optimizer state and step, inputs, caches and their
  position) equal the per-device bytes of the reference's own specs
  (``param_spec_tree``, ``_opt_shardings``, ``batch_shardings``,
  ``cache_shardings``; shard shapes, nothing compiled), the two sides in
  two subprocesses (512 fake ranks, 512 forced host devices).  That
  holds for arctic-480b's Adafactor too: the port's Adafactor stacks each
  superblock position's per-layer leaves as the reference's tree does,
  so it factors a stacked (L, d) norm scale into (L,) + (d,) as the
  reference does.
* ``model_flops_info`` equals the reference's for all eleven archs.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

# importing the reference's dryrun sets XLA_FLAGS to 512 forced devices in
# this process; restore it (the suite's in-process tests see one device)
_saved_xla_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402

if _saved_xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved_xla_flags

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro_torch.configs import registry as preg  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import dryrun as pdry  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

HLO = """
ENTRY main {
  %p = f32[2048,512]{1,0} parameter(0)
  %ar = f32[2048,512]{1,0} all-reduce(f32[2048,512]{1,0} %p), replica_groups={}
  %ag = bf16[64,128]{1,0} all-gather(bf16[32,128]{1,0} %x), dimensions={0}
  %rs = f32[16]{0} reduce-scatter(f32[64]{0} %y), dimensions={0}
  %cp = u8[10]{0} collective-permute(u8[10]{0} %z), source_target_pairs={{0,1}}
  %dot = f32[4,4]{1,0} dot(f32[4,8]{1,0} %a, f32[8,4]{1,0} %b)
}
"""

REF_BYTES = r"""
import json, math, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp
from repro.launch import dryrun as D
from repro.configs import registry
from repro.configs.base import SHAPES, shape_applicable
from repro.launch.mesh import make_production_mesh
from repro.models import lm
from repro.parallel import sharding as shd
from repro.train.optimizer import make_optimizer
from repro.train.trainstep import init_state


def tbytes(sds, sh):
    return sum(jax.tree.leaves(jax.tree.map(
        lambda a, s: math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize,
        sds, sh)))


out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in registry.ARCHS:
        cfg = registry.get_config(arch)
        rules = D._rules(arch, mesh)
        psds = jax.eval_shape(lambda: lm.init_params(jax.random.PRNGKey(0),
                                                     cfg))
        pb = tbytes(psds, shd.param_spec_tree(psds, mesh,
                                              registry.arch_rules(arch)))
        for s in SHAPES.values():
            if not shape_applicable(arch, s.name, cfg.family):
                continue
            specs = registry.input_specs(cfg, s, abstract=True)
            total = pb + tbytes(specs, D.batch_shardings(cfg, specs, mesh,
                                                         rules))
            if s.kind == "train":
                st = jax.eval_shape(lambda: init_state(
                    jax.random.PRNGKey(0), cfg, make_optimizer(cfg.optimizer)))
                total += tbytes(st.opt, D._opt_shardings(st.opt, mesh, rules))
                total += tbytes(st.step, D.NamedSharding(mesh, D.P()))
            elif s.kind == "decode":
                c = jax.eval_shape(lambda: lm.init_caches(
                    cfg, s.global_batch, s.seq_len, jnp.bfloat16))
                total += tbytes(c, D.cache_shardings(cfg, c, mesh, rules))
            out[f"{arch}/{s.name}/{int(multi)}"] = int(total)
print(json.dumps(out))
"""

PORT_BYTES = r"""
import json
from repro_torch.configs import registry
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
D.fake_group(512)
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in registry.ARCHS:
        for s in registry.applicable_shapes(arch):
            cell = D.lower_cell(arch, s.name, mesh)
            out[f"{arch}/{s.name}/{int(multi)}"] = cell.argument_bytes
print(json.dumps(out))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    return env


def test_shape_bytes():
    for fn in (pdry._shape_bytes, jdry._shape_bytes):
        assert fn("f32[2048,512]") == 2048 * 512 * 4
        assert fn("bf16[3]") == 6
        assert fn("pred[]") == 1
        assert fn("token[]") == 0


def test_collective_bytes_parses_operands():
    c = pdry.collective_bytes(HLO)
    assert c == jdry.collective_bytes(HLO)
    assert c["all-reduce"] == 2048 * 512 * 4
    assert c["all-gather"] == 32 * 128 * 2
    assert c["reduce-scatter"] == 64 * 4
    assert c["collective-permute"] == 10
    assert c["all-to-all"] == 0
    assert c["count"] == 4


def test_dryrun_cell_subprocess(tmp_path):
    out = tmp_path / "dryrun.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "jag-surrogate", "--shape", "train_4k", "--out", str(out)],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    res = json.loads(out.read_text())[0]
    assert res["ok"]
    assert res["chips"] == 256 and res["mesh"] == "16x16"
    assert res["flops"] > 0
    assert res["memory"]["temp_bytes"] > 0
    assert res["memory"]["argument_bytes"] > 0
    assert res["kernel_flops"]["flash_attention_bwd"] > 0
    assert res["reconstructed"]["flops"] > res["flops"] * 0.5
    assert res["model_flops"] == jdry.model_flops_info(
        jreg.get_config("jag-surrogate"), JSHAPES["train_4k"])["model_flops"]


def test_argument_bytes_equal_the_reference_specs():
    ref = subprocess.Popen([sys.executable, "-c", REF_BYTES], env=_env(),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    port = subprocess.run([sys.executable, "-c", PORT_BYTES], env=_env(),
                          capture_output=True, text=True, timeout=400)
    ref_out, ref_err = ref.communicate(timeout=400)
    assert port.returncode == 0, port.stderr[-3000:]
    assert ref.returncode == 0, ref_err[-3000:]
    got = json.loads(port.stdout.strip().splitlines()[-1])
    want = json.loads(ref_out.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert len(got) == 2 * sum(len(preg.applicable_shapes(a))
                               for a in preg.ARCHS)
    # every cell, arctic's Adafactor train cells included: the port's
    # Adafactor keys its moments by the reference's stacked leaves
    for key, n in want.items():
        assert got[key] == n, (key, got[key], n)


@pytest.mark.parametrize("arch", sorted(preg.ARCHS))
def test_model_flops_info_is_the_reference(arch):
    for name in SHAPES:
        assert pdry.model_flops_info(preg.get_config(arch), SHAPES[name]) == \
            jdry.model_flops_info(jreg.get_config(arch), JSHAPES[name])
