"""Training path of the PyTorch port against the JAX reference, on the CPU:
optimizers, checkpoints, the trainer, ``loss_fn`` and its gradients, the
train step, a loss curve, remat, and ``launch.train``.

Inputs, parameters and optimizer states are made on the JAX side (or with
numpy from a seed) and handed over as numpy arrays; ``convert`` loads them.
float32 compute: loss and gradients at rel 1e-4 (max error over the
largest magnitude), one optimizer update at 1e-6, a 10-step loss curve at
1e-3; bf16 compute only at 5e-2, since bf16 rounds at other places in the
two frameworks.  After AdamW's first step a parameter near a zero gradient
moves by about lr times the gradient's sign, which flips between
frameworks, so after a step the moments, loss and grad norm are held, not
the parameters.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.bundler import Bundler as JBundler
from repro.data.pipeline import ensemble_token_stream as jax_stream
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train.trainstep import init_state as jinit
from repro.train.trainstep import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.ckpt.checkpoint import (CheckpointManager, restore_pytree,
                                         save_pytree)
from repro_torch.configs import registry as preg
from repro_torch.core.bundler import Bundler
from repro_torch.data.pipeline import SyntheticTokens, ensemble_token_stream
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.train import optimizer as popt
from repro_torch.train.trainer import Trainer
from repro_torch.train.trainstep import (make_eval_step, make_train_step,
                                         named_params)


def rel_err(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def configs(dtype="float32", **over):
    jc = jreg.reduced_config("jag-surrogate").replace(compute_dtype=dtype,
                                                      **over)
    pc = preg.reduced_config("jag-surrogate").replace(compute_dtype=dtype,
                                                      **over)
    return jc, pc


def tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# optimizers (the reference's cases, tests/test_substrate.py, on the port)
# ---------------------------------------------------------------------------

def _quad_params():
    return {"w": torch.zeros(4, requires_grad=True),
            "m": torch.zeros((3, 5), requires_grad=True)}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_converges_on_quadratic(name):
    t1 = torch.tensor([1.0, -2.0, 3.0, 0.5])
    t2 = torch.arange(15.0).reshape(3, 5) / 10
    p = _quad_params()
    # a tree with no layers: Adafactor's layout is None (every leaf its own)
    opt = popt.make_optimizer(name, lr=0.05, wd=0.0) if name == "adamw" \
        else popt.adafactor(lr=0.05, layout=None)
    st = opt.init(p)

    def loss(pp):
        return torch.sum((pp["w"] - t1) ** 2) + torch.sum((pp["m"] - t2) ** 2)

    for _ in range(400):
        g = dict(zip(p, torch.autograd.grad(loss(p), list(p.values()))))
        p, st = opt.update(g, st, p)
    assert float(loss(p).detach()) < 1e-2


def test_make_optimizer_adafactor_needs_the_models_layout():
    """Adafactor stacks a model's per-layer leaves by its layout: without
    the config make_optimizer refuses it (it would silently be another
    optimizer than the reference's); AdamW needs no config."""
    with pytest.raises(ValueError, match="pass cfg"):
        popt.make_optimizer("adafactor", lr=0.05)
    cfg = preg.reduced_config("arctic-480b")
    names = [f"layers.{i}.norm1.scale" for i in range(cfg.n_layers)]
    p = {n: torch.zeros(8) for n in names}
    st = popt.make_optimizer("adafactor", lr=0.05, cfg=cfg).init(p)
    n_pro, n_sb = popt.layout_of(cfg)
    assert len(st["f"]) == n_pro + n_sb
    assert popt.make_optimizer("adamw", lr=0.05).init(p)


def test_adafactor_state_is_factored():
    p = {"big": torch.zeros((64, 128)), "vec": torch.zeros(10)}
    st = popt.adafactor().init(p)
    assert st["f"]["big"]["vr"].shape == (64,)
    assert st["f"]["big"]["vc"].shape == (128,)
    assert st["f"]["vec"]["v"].shape == (10,)


def test_ef_compression_converges_and_carries_residual():
    t = torch.tensor([1.0, -2.0, 3.0])
    p = {"w": torch.zeros(3, requires_grad=True)}
    opt = popt.ef_compress(popt.adamw(lr=0.05, wd=0.0), bits=8)
    st = opt.init(p)
    for _ in range(300):
        (g,) = torch.autograd.grad(torch.sum((p["w"] - t) ** 2), [p["w"]])
        p, st = opt.update({"w": g}, st, p)
    assert float((p["w"] - t).detach().abs().max()) < 0.05
    assert float(st["ef"]["w"].abs().max()) > 0  # the residual is carried


OPTIMIZERS = {
    "adamw": lambda m: m.adamw(lr=1e-2, wd=0.1),
    "adamw_clipped": lambda m: m.adamw(lr=1e-2, wd=0.1, clip_norm=0.5),
    "adafactor": lambda m: m.adafactor(lr=1e-2),
    "ef_adamw": lambda m: m.ef_compress(m.adamw(lr=1e-2)),
}


def _leaves(tree, prefix=""):
    """{'a': {'b': x}} -> {'a.b': x}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_update_matches_reference(name):
    """Three updates from the same numpy params and gradients on both
    sides: parameters and every state leaf at rel 1e-6 after each."""
    rng = np.random.default_rng(len(name))
    shapes = {"emb": (16, 8), "vec": (8,), "w": (2, 8, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jo, po = OPTIMIZERS[name](jopt), OPTIMIZERS[name](popt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), po.init(tp)
    for _ in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        jp, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()},
                           js, jp)
        tp, ts = po.update({k: torch.from_numpy(v) for k, v in grads.items()},
                           ts, tp)
        for k in shapes:
            assert rel_err(tp[k], jp[k]) < 1e-6, k
        jl, tl = _leaves(to_numpy(js)), _leaves(ts)
        assert sorted(jl) == sorted(tl)
        for k in jl:
            assert rel_err(tl[k], jl[k]) < 1e-6, k


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": [torch.ones(4), {"c": torch.zeros(2)}],
            "h": torch.ones(3, dtype=torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for step in [5, 10, 15]:
        mgr.save(step, tree)
    assert mgr.steps() == [10, 15]  # gc kept last 2
    got = mgr.restore(15, like=tree)
    assert torch.equal(got["a"], tree["a"])
    assert torch.equal(got["b"][1]["c"], torch.zeros(2))
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"], tree["h"])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    assert sorted(os.listdir(tmp_path / "step_000000015")) == [
        "leaf_00000.npy", "leaf_00001.npy", "leaf_00002.npy",
        "leaf_00003.npy", "leaf_00004.npy", "manifest.json"]


def test_checkpoint_atomic_no_partial_reads(tmp_path):
    tree = {"a": torch.ones(3)}
    save_pytree(str(tmp_path / "ck"), tree)
    assert torch.equal(restore_pytree(str(tmp_path / "ck"), tree)["a"],
                       tree["a"])
    # a leftover tmp dir from a crashed writer must be ignored
    os.makedirs(str(tmp_path / "ck2.tmp"))
    os.makedirs(str(tmp_path / "step_000000003"))  # no manifest
    mgr = CheckpointManager(str(tmp_path), keep=5)
    assert mgr.steps() == []  # tmp/non-manifest dirs invisible


def test_async_save_snapshots_before_in_place_updates(tmp_path):
    """The host copy is taken when save() is called: an in-place update
    right after it does not reach the checkpoint."""
    t = torch.zeros(1000)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, {"t": t})
    t.add_(1.0)
    mgr.wait()
    assert float(mgr.restore(1, like={"t": t})["t"].abs().max()) == 0.0


def test_trainer_restart_resumes(tmp_path):
    cfg = preg.get_config("jag-surrogate").replace(
        n_repeat=1, n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
        head_dim=16, d_ff=64, vocab_size=128)
    tr = Trainer(cfg, str(tmp_path), iter(SyntheticTokens(2, 16, 128)),
                 ckpt_every=3, device="cpu")
    st = tr.train(5)
    tr2 = Trainer(cfg, str(tmp_path), iter(SyntheticTokens(2, 16, 128)),
                  ckpt_every=3, device="cpu")
    st2 = tr2.restore_or_init()
    assert int(st2.step) == 5
    for name, p in named_params(st2.params).items():
        assert torch.equal(p, named_params(st.params)[name]), name
    for k in ("m", "v"):
        for name, a in st2.opt[k].items():
            assert torch.equal(a, st.opt[k][name]), name
    st2 = tr2.train(7, state=st2)
    assert int(st2.step) == 7
    assert tr2.history[0]["step"] == 6  # resumed, not restarted


# ---------------------------------------------------------------------------
# loss, gradients, the train step, the loss curve
# ---------------------------------------------------------------------------

def test_loss_fn_and_gradients_match_reference():
    jc, pc = configs()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jc)
    batch = SyntheticTokens(2, 32, jc.vocab_size, seed=1).batch_at(0)
    batch["labels"][0, -3:] = -1  # masked labels drop out of the mean
    (jloss, jm), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    model = convert.params_from_jax(to_numpy(jparams), pc, "cpu")
    loss, metrics = lm.loss_fn(model, tensors(batch), pc)
    assert rel_err(loss, jloss) < 1e-4
    assert float(metrics["ntokens"]) == float(jm["ntokens"]) == 61
    loss.backward()
    want = convert._state_dict(to_numpy(jg), pc)
    for name, p in model.named_parameters():
        assert rel_err(p.grad, want[name]) < 1e-4, name
    # the eval step is the loss without a gradient
    ev = make_eval_step(pc)(model, batch)
    assert rel_err(ev["loss"], jloss) < 1e-4


def _both_states(jc, pc, lr=1e-3):
    jo = jopt.make_optimizer("adamw", lr=lr)
    jstate = jinit(jax.random.PRNGKey(0), jc, jo)
    pstate = convert.train_state_from_jax(
        (to_numpy(jstate.params), to_numpy(jstate.opt),
         np.asarray(jstate.step)), pc, "cpu")
    return jo, jstate, popt.make_optimizer("adamw", lr=lr), pstate


def test_train_step_with_microbatches_matches_reference():
    jc, pc = configs(microbatch=2)
    jo, jstate, po, pstate = _both_states(jc, pc)
    batch = SyntheticTokens(4, 32, jc.vocab_size).batch_at(0)
    js2, jm = jax.jit(jmake_step(jc, jo))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    ps2, pm = make_train_step(pc, po)(pstate, batch)
    assert int(pm["step"]) == int(jm["step"]) == 1 == int(ps2.step)
    assert rel_err(pm["loss"], jm["loss"]) < 1e-4
    assert rel_err(pm["grad_norm"], jm["grad_norm"]) < 1e-4
    for k in ("m", "v"):
        want = convert._state_dict(to_numpy(js2.opt[k]), pc)
        for name, a in ps2.opt[k].items():
            assert rel_err(a, want[name]) < 1e-4, (k, name)


# the archs whose layers train through the scans' and D-192 attention's
# backward kernels on the card (WKV6, SSD with zamba2's shared attention,
# MLA with MoE); here their plain versions under autograd
SCAN_MOE_ARCHS = ("rwkv6-3b", "zamba2-1.2b", "deepseek-v2-lite-16b")


def _arch_configs(arch, **over):
    kw = dict(compute_dtype="float32", param_dtype="float32",
              accum_dtype="float32", **over)
    return (jreg.reduced_config(arch).replace(**kw),
            preg.reduced_config(arch).replace(**kw))


@pytest.mark.parametrize("arch", SCAN_MOE_ARCHS)
def test_scan_and_moe_archs_loss_and_gradients_match_reference(arch):
    """Reduced configs in float32: loss and every parameter's gradient
    against jax.grad of the reference's loss_fn at rel 1e-4."""
    jc, pc = _arch_configs(arch)
    jparams = jlm.init_params(jax.random.PRNGKey(1), jc)
    batch = SyntheticTokens(2, 24, jc.vocab_size, seed=2).batch_at(0)
    (jloss, _), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    model = convert.params_from_jax(to_numpy(jparams), pc, "cpu")
    loss, _ = lm.loss_fn(model, tensors(batch), pc)
    assert rel_err(loss, jloss) < 1e-4
    loss.backward()
    want = convert._state_dict(to_numpy(jg), pc)
    for name, p in model.named_parameters():
        # a parameter the loss never reads has no gradient in torch, a
        # zero one in JAX (zamba2's shared block's norm1)
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        if not float(torch.as_tensor(want[name]).abs().max()):
            assert float(got.abs().max()) == 0.0, name
            continue
        assert rel_err(got, want[name]) < 1e-4, name


@pytest.mark.parametrize("arch", SCAN_MOE_ARCHS)
def test_scan_and_moe_archs_adamw_step_matches_reference(arch):
    """One train step (AdamW, two microbatches) from the same state: loss,
    gradient norm and both moments at rel 1e-4."""
    jc, pc = _arch_configs(arch, microbatch=2)
    jo, jstate, po, pstate = _both_states(jc, pc)
    batch = SyntheticTokens(4, 24, jc.vocab_size, seed=3).batch_at(0)
    js2, jm = jax.jit(jmake_step(jc, jo))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    ps2, pm = make_train_step(pc, po)(pstate, batch)
    assert rel_err(pm["loss"], jm["loss"]) < 1e-4
    assert rel_err(pm["grad_norm"], jm["grad_norm"]) < 1e-4
    for k in ("m", "v"):
        want = convert._state_dict(to_numpy(js2.opt[k]), pc)
        for name, a in ps2.opt[k].items():
            if not float(torch.as_tensor(want[name]).abs().max()):
                assert float(a.abs().max()) == 0.0, (k, name)
                continue
            assert rel_err(a, want[name]) < 1e-4, (k, name)


def test_adafactor_steps_match_reference_on_stacked_leaves():
    """arctic-480b (reduced; Adafactor): the reference's initial state
    carried across by train_state_from_jax, then three updates from the
    same numpy gradients on both sides.  The port's Adafactor stacks each
    superblock position's per-layer leaves as the reference's tree holds
    them, so every parameter and every moment (keyed by the stacked
    names, with the reference's shapes: (L, d) norm scales factored into
    (L,) + (d,)) agrees at rel 1e-6 after each step."""
    jc, pc = _arch_configs("arctic-480b")
    assert jc.optimizer == pc.optimizer == "adafactor" and pc.n_repeat > 1
    jo = jopt.make_optimizer(jc.optimizer, lr=1e-2)
    po = popt.make_optimizer(pc.optimizer, lr=1e-2, cfg=pc)
    jstate = jinit(jax.random.PRNGKey(0), jc, jo)
    pstate = convert.train_state_from_jax(
        (to_numpy(jstate.params), to_numpy(jstate.opt),
         np.asarray(jstate.step)), pc, "cpu")
    jp, js = jstate.params, jstate.opt
    params, opt = named_params(pstate.params), pstate.opt
    norm = opt["f"]["blocks.0.norm1.scale"]
    assert set(norm) == {"vr", "vc"}
    assert tuple(norm["vr"].shape) == (pc.n_repeat,)
    rng = np.random.default_rng(4)
    for _ in range(3):
        grads = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
        jp, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tg = {k: v for k, v in convert._state_dict(grads, pc).items()}
        params, opt = po.update(tg, opt, params)
        want = convert._state_dict(to_numpy(jp), pc)
        for name, a in params.items():
            assert rel_err(a, want[name]) < 1e-6, name
        got_f = _leaves(opt["f"])
        want_f = _leaves(convert._adafactor_state(
            to_numpy(js["f"]), params, pc, "cpu"))
        assert sorted(got_f) == sorted(want_f)
        for k in want_f:
            assert rel_err(got_f[k], want_f[k]) < 1e-6, k


@pytest.mark.parametrize("dtype,steps,rel", [("float32", 10, 1e-3),
                                             ("bfloat16", 1, 5e-2)])
def test_loss_curve_matches_reference(dtype, steps, rel):
    jc, pc = configs(dtype)
    jo, jstate, po, pstate = _both_states(jc, pc, lr=3e-3)
    data = SyntheticTokens(4, 32, jc.vocab_size)
    jstep, pstep = jax.jit(jmake_step(jc, jo)), make_train_step(pc, po)
    jl, pl = [], []
    for i in range(steps):
        batch = data.batch_at(i % 2)  # two batches in turn: it can learn
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, pm = pstep(pstate, batch)
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
    assert rel_err(np.array(pl), np.array(jl)) < rel
    if steps > 1:
        assert pl[-1] < pl[0]  # it learns


def _mm_calls_in_backward(cfg, batch):
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    loss, _ = lm.loss_fn(model, batch, cfg)
    with Count():
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, grads, Count.n


def test_remat_modes_give_the_same_loss_and_grads():
    """none / full / dots: one loss and one gradient; ``full`` recomputes
    each layer's matrix products in the backward, ``dots`` keeps them."""
    _, pc = configs()
    batch = tensors(SyntheticTokens(2, 16, pc.vocab_size).batch_at(0))
    res = {r: _mm_calls_in_backward(pc.replace(remat=r), batch)
           for r in ("none", "full", "dots")}
    loss0, g0, n0 = res["none"]
    for r in ("full", "dots"):
        loss, g, _ = res[r]
        assert float(loss.detach()) == float(loss0.detach())
        for a, b in zip(g, g0):
            assert rel_err(a, b) < 1e-6
    assert res["full"][2] > n0 == res["dots"][2]


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------

def test_launch_train_resumes_in_the_same_workdir(tmp_path):
    args = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--workdir", str(tmp_path)]
    summary, tr = launch_train.main(args + ["--steps", "4"])
    assert summary["steps"] == 4 and summary["ran_steps"] == 4
    assert summary["device"] == "cpu" and summary["flash_launches"] == 0
    summary, tr = launch_train.main(args + ["--steps", "6"])
    assert summary["steps"] == 6 and summary["ran_steps"] == 2
    assert tr.history[0]["step"] == 5


def _write_study(root, n=48, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.random((n, 5)).astype(np.float32)
    out = {"inputs": X}
    for i, key in enumerate(launch_train.SCALAR_KEYS):
        out[key] = (X[:, i] * (i + 1) + rng.random(n)).astype(np.float32)
    Bundler(root).write_bundle(0, n // 2, {k: v[:n // 2] for k, v in out.items()})
    Bundler(root).write_bundle(n // 2, n, {k: v[n // 2:] for k, v in out.items()})


def test_launch_train_over_bundles(tmp_path):
    """--data reads a bundler root through the port's Bundler and token
    stream; the first batch equals the reference's stream's over the same
    bundles."""
    root = str(tmp_path / "study")
    _write_study(root)
    vocab = preg.get_config("jag-surrogate").vocab_size
    got = next(ensemble_token_stream(Bundler(root).load_all(),
                                     launch_train.SCALAR_KEYS, batch=8,
                                     vocab=vocab))
    want = next(jax_stream(JBundler(root).load_all(),
                           launch_train.SCALAR_KEYS, batch=8, vocab=vocab))
    for k in ("tokens", "labels"):
        assert got[k].shape == (8, 8)
        np.testing.assert_array_equal(got[k], want[k])
    summary, _ = launch_train.main(
        ["--device", "cpu", "--data", root, "--steps", "2",
         "--workdir", str(tmp_path / "w")])
    assert summary["ran_steps"] == 2 and np.isfinite(summary["final_loss"])


def test_launch_train_on_the_cpu_trains_scan_models(tmp_path):
    """The CPU trains rwkv6 layers through the plain versions under
    autograd (the card through the WKV6 backward kernel)."""
    summary, _ = launch_train.main(
        ["--device", "cpu", "--arch", "rwkv6-3b", "--reduced", "--batch", "2",
         "--seq", "16", "--steps", "1", "--workdir", str(tmp_path)])
    assert summary["ran_steps"] == 1 and np.isfinite(summary["final_loss"])
