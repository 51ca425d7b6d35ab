"""The port's int8 all-reduce over 8 gloo ranks against the reference's
over 8 forced host devices (the script of ``tests/test_collectives.py``,
in a subprocess), on the same numpy inputs; and the rows each rank owns
under a spec, against the blocks JAX gives each device.

Both sides quantize against one all-reduced absmax scale and sum int8
payloads as int32, so on values already on the integer grid they agree
exactly, and elsewhere within one quantization step (float division may
round a tie the other way); each is within the reference's 2e-2 of the
true sum.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np

import _torch_dist

WORLD = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.parallel.collectives import compressed_grad_allreduce
    inputs, out_path, specs = sys.argv[1], sys.argv[2], eval(sys.argv[3])
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("data",))
    out = {}
    for name, arr in np.load(inputs).items():
        g = jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P("data")))
        out[name] = np.asarray(compressed_grad_allreduce({"w": g}, mesh)["w"])
    mesh2 = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    for key, spec in specs.items():
        idx = NamedSharding(mesh2, P(*spec)).devices_indices_map((16, 8))
        for d, (rows, cols) in idx.items():
            r0, c0 = rows.start or 0, cols.start or 0
            out[f"block_{key}_{d.id}"] = np.array(
                [r0, c0, (rows.stop or 16) - r0, (cols.stop or 8) - c0])
    np.savez(out_path, **out)
""")


def test_compressed_grad_allreduce_matches_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, g=rng.normal(size=(WORLD, 64, 16)).astype(np.float32),
             gi=rng.integers(-5, 6, size=(WORLD, 32)).astype(np.float32))
    ref_out = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(inputs), str(ref_out),
         repr(_torch_dist.SPECS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    work = tmp_path / "ranks"
    work.mkdir()
    _torch_dist.spawn(_torch_dist.collectives_rank, WORLD, str(work), 180,
                      str(inputs))
    _, err = ref.communicate(timeout=180)
    assert ref.returncode == 0, err[-2000:]
    want = np.load(ref_out)
    got = [np.load(work / f"out_{r}.npz") for r in range(WORLD)]
    arrays = np.load(inputs)
    for name in ("g", "gi"):
        for r in range(WORLD):  # the same reduced result on every rank
            assert np.array_equal(got[r][name], got[0][name])
            assert np.array_equal(got[r][f"{name}_psum"], got[0][name])
        total = arrays[name].sum(axis=0)
        assert got[0][name].shape == want[name].shape == total.shape
        step = np.abs(arrays[name]).max() / 127  # one quantization step
        assert np.abs(got[0][name] - want[name]).max() <= step * (1 + 1e-6)
        assert np.abs(got[0][name] - total).max() / np.abs(total).max() < 2e-2
    assert np.array_equal(got[0]["gi"], want["gi"])
    # the rows and columns each rank holds are the block JAX gives the
    # device at the same mesh position
    for key in _torch_dist.SPECS:
        for r in range(WORLD):
            assert np.array_equal(got[r][f"block_{key}"],
                                  want[f"block_{key}_{r}"]), (key, r)
