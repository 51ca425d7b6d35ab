"""Training steps under a (2, 2) mesh of 4 gloo ranks equal the port's
unsharded steps, for the layer kinds beside ``tests/test_torch_elastic.py``'s
attn + glu: whisper's encoder and decoder (``dec``), llama-vision's gated
cross-attention (``xattn``), RWKV6 and zamba2's Mamba2 + shared attention.

Two steps each from one seeded state (``shard_state`` places it), float32
compute: both losses and gradient norms, and the stepped ``embed`` and
``layers.0.*`` parameters, within rel 1e-5 (only the order of the sums
differs).  And a layer under remat holds its weights whole only inside
its own call: when a layer gathers its weights, none that an earlier
remat layer gathered is still alive (zamba2's prologue runs outside
remat, as the reference's does, and keeps them for its backward).  A
layer gathers its weights outside the step's thread-local rules as well:
on the card autograd recomputes a remat layer on its own device thread.
"""
import json

import numpy as np
import pytest

import _torch_dist

ARCHS = ["whisper-tiny", "llama-3.2-vision-11b", "rwkv6-3b", "zamba2-1.2b"]
REL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    _torch_dist.spawn(_torch_dist.mesh_train_rank, 4, str(tmp), 240, ARCHS, 2)
    return tmp, json.loads((tmp / "mesh_train.json").read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_steps_equal_the_unsharded_steps(runs, arch):
    tmp, out = runs
    plain, mesh = out[f"{arch}/plain"], out[f"{arch}/mesh"]
    for (lp, gp), (lm_, gm) in zip(plain["metrics"], mesh["metrics"]):
        assert abs(lm_ - lp) / lp < REL, (lm_, lp)
        assert abs(gm - gp) / gp < REL, (gm, gp)
    want = np.load(tmp / f"{arch}_plain.npz")
    got = np.load(tmp / f"{arch}_mesh.npz")
    assert set(got.files) == set(want.files) and "embed" in want.files
    for k in want.files:
        rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert rel < REL, (k, rel)
    assert mesh["still_whole"] == 0
    assert out[f"{arch}/whole_outside_rules"]
