"""Tensor parallelism over the ``model`` mesh axis: under (2, 2) and (1, 4)
meshes of gloo ranks, two training steps of every layer kind the port
trains under a mesh (attn + glu: jag-surrogate; mla: deepseek's dense
prologue and MoE layers; gelu_mlp: starcoder2; xattn: llama-vision; dec and
the encoder: whisper; rwkv6; mamba2 + shared_attn: zamba2; and a GQA
config with 8 query and 2 KV heads, which on 4 ranks puts two query heads
of one KV head on each) equal the unsharded steps: losses, gradient
norms, the eval losses before each step and every stepped parameter within
rel 1e-5 (float32; only the order of the sums differs).

The weights stay split: no tensor whose global shape is that of a weight
split over ``model`` is ever all-gathered over ``model`` during the
steps (DTensor's redistributions are recorded, asked-for and implicit
alike; the batch of 8 x 12 tokens keeps activations' shapes apart from the
weights').  And the flash and WKV6 dispatch receive H / model local heads
wherever H divides the ``model`` size; with 8:2 GQA on 4 ranks each rank
passes its 2 query heads and the 1 KV head they read.
"""
import json

import numpy as np
import pytest

import _torch_dist

REL = 1e-5
CASES = [("jag", "jag-surrogate", {}),
         ("mla", "deepseek-v2-lite-16b", {"moe_group": 32}),
         ("gelu", "starcoder2-15b", {}),
         ("xattn", "llama-3.2-vision-11b", {}),
         ("dec", "whisper-tiny", {}),
         ("rwkv6", "rwkv6-3b", {}),
         # one superblock (10 layers): at 17, float32 sum-order noise in
         # the dt_bias gradients reaches 1e-5 under (1, 4)
         ("mamba2", "zamba2-1.2b", {"n_repeat": 1, "n_layers": 10}),
         ("gqa", "jag-surrogate", {"n_heads": 8, "n_kv_heads": 2})]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
RUNS = [(mesh, c[0]) for mesh in MESHES for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    _torch_dist.spawn(_torch_dist.tensor_parallel_rank, 4, str(tmp), 420,
                      CASES, list(MESHES.values()), 2, 8, 12)
    return tmp, json.loads((tmp / "tp.json").read_text())


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("mesh,label", RUNS)
def test_mesh_steps_equal_the_unsharded_steps(runs, mesh, label):
    tmp, out = runs
    res = out[label]
    for got, want in zip(res[mesh], res["plain"]):
        for g, w in zip(got, want):
            assert _rel(g, w) < REL or abs(g - w) < 1e-12, (got, want)
    want = np.load(tmp / f"{label}_plain.npz")
    got = np.load(tmp / f"{label}_{mesh}.npz")
    assert set(got.files) == set(want.files)
    for k in want.files:
        rel = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]),
                                                     1e-12)
        assert rel < REL, (k, rel)


@pytest.mark.parametrize("mesh,label", RUNS)
def test_no_weight_split_on_model_is_gathered_over_model(runs, mesh, label):
    _, out = runs
    res = out[label]
    split = {tuple(s) for s in res[f"split/{mesh}"]}
    if label != "dec":  # whisper runs pure data-parallel: nothing is split
        assert split
    shapes = split | {s[::-1] for s in split}
    assert not shapes & {tuple(s) for s in res[f"gathered/{mesh}"]}


@pytest.mark.parametrize("mesh,label", RUNS)
def test_kernels_receive_the_local_heads(runs, mesh, label):
    _, out = runs
    res = out[label]
    model = MESHES[mesh][1]
    H, _, H_wkv = res["n_heads"]
    split = label != "dec"  # whisper's batch is split over model instead

    def local(h):
        return h // model if split and h % model == 0 else h
    calls = res[f"heads/{mesh}"]
    assert calls["flash"] or calls["wkv6"]
    assert all(q == local(H) for q, _ in calls["flash"]), calls["flash"]
    assert all(h == local(H_wkv) for (h,) in calls["wkv6"]), calls["wkv6"]
    if label == "rwkv6":
        assert calls["wkv6"]
    if label == "gqa" and model == 4:  # 2 query heads of one KV head a rank
        assert calls["flash"] and all(c == [2, 1] for c in calls["flash"])
