"""Training the encoder archs on the port against the reference, on the
CPU: whisper-tiny (encoder + decoder cross-attention) and
llama-3.2-vision-11b (gated cross-attention over image tokens), reduced.

Weights come from the reference's ``init_params`` through numpy; every
llama-vision ``xgate`` is drawn from U(0.5, 1.5), since at its init of 0
tanh(0) hides the layer and its gradients would be zero.  Extras are
N(0, 1) from a numpy seed, handed to both sides as float32.  float32
compute: the loss and every gradient at rel 1e-4 (max error over the
largest magnitude), and three ``make_train_step`` steps from one state
(``convert.train_state_from_jax``) at rel 1e-4 a step.  There is no
decode cache in training, so the cross-attention cache's two rounding
points do not enter.  Then ``launch.train`` on both archs prints the
reference launcher's keys.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.launch import train as jlaunch_train
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train.trainstep import init_state as jinit
from repro.train.trainstep import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.train import optimizer as popt
from repro_torch.configs import registry as preg
from repro_torch.train.trainstep import init_state, make_train_step
from test_torch_lm import extras, pair, rel_err, to_numpy

ARCHS = ["whisper-tiny", "llama-3.2-vision-11b"]
REL = 1e-4


def _batch(pc, seed=3, B=2, S=16):
    toks = np.random.default_rng(seed).integers(
        0, pc.vocab_size, (B, S + 1)).astype(np.int32)
    jex, tex = extras(pc, B, seed=seed + 1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return ({**{k: jnp.asarray(v) for k, v in batch.items()}, **jex},
            {**{k: np.array(v) for k, v in batch.items()},
             **{k: v.numpy() for k, v in tex.items()}})


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch):
    jc, pc, jparams, model = pair(arch, "float32")
    jb, pb = _batch(pc)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jc), has_aux=True))(jparams, jb)
    params = dict(model.named_parameters())
    loss, _ = lm.loss_fn(model, {k: torch.from_numpy(v) for k, v in
                                 pb.items()}, pc)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert rel_err(loss, jloss) < REL
    want = convert._state_dict(to_numpy(jg), pc)
    assert set(want) == set(grads)
    for name, g in grads.items():
        assert rel_err(g, want[name]) < REL, name
    # the cross-attention is live: its weights and gates get gradients
    live = [n for n in grads if ("xattn" in n or "xgate" in n)
            and float(grads[n].abs().max()) > 0]
    assert live


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_the_reference(arch):
    jc, pc, jparams, _ = pair(arch, "float32")
    jc, pc = jc.replace(microbatch=2), pc.replace(microbatch=2)
    opt = jopt.make_optimizer(jc.optimizer, lr=1e-3)
    state = jinit(jax.random.PRNGKey(0), jc, opt)._replace(params=jparams)
    state = state._replace(opt=opt.init(jparams))
    pstate = convert.train_state_from_jax(
        jax.tree.map(np.asarray, tuple(state)), pc, "cpu")
    jstep = jax.jit(jmake_step(jc, opt))
    pstep = make_train_step(pc, popt.make_optimizer(pc.optimizer, lr=1e-3))
    for i in range(3):
        jb, pb = _batch(pc, seed=10 + i, B=4)
        state, jm = jstep(state, jb)
        pstate, pm = pstep(pstate, pb)
        for key in ("loss", "grad_norm"):
            assert rel_err(pm[key], jm[key]) < REL, (i, key)
        assert int(pm["step"]) == int(jm["step"]) == i + 1


def _run(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out)


def test_launch_train_prints_the_reference_keys(tmp_path, capsys):
    args = ["--arch", "whisper-tiny", "--reduced", "--steps", "1",
            "--batch", "2", "--seq", "16"]
    ref = _run(jlaunch_train.main, args + ["--workdir", str(tmp_path / "j")],
               capsys)
    for arch in ARCHS:
        out = _run(launch_train.main,
                   ["--arch", arch, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16",
                    "--workdir", str(tmp_path / arch)], capsys)
        assert set(ref) <= set(out), set(ref) - set(out)
        assert out["arch"] == arch and out["steps"] == out["ran_steps"] == 2
        assert np.isfinite(out["final_loss"])
        assert out["flash_launches"] == out["flash_bwd_launches"] == 0


def test_launcher_feeds_the_reference_extras_in_bf16():
    """Step k's extras are the ones the reference's stream draws at step k
    (bfloat16 numpy there; float32 cast in torch here: the same values),
    on the synthetic stream and on any other."""
    shape = (2, 6, 4)
    ref = JSyntheticTokens(2, 8, 512, extras={"enc_embed": (shape,
                                                            "bfloat16")})
    extras = {"enc_embed": (shape, "bfloat16")}
    got = launch_train.with_extras(JSyntheticTokens(2, 8, 512), extras)
    other = launch_train.with_extras(iter([{"tokens": 0}] * 3), extras)
    for step in range(3):
        want, g, o = ref.batch_at(step), next(got), next(other)
        assert g["enc_embed"].dtype == o["enc_embed"].dtype == torch.bfloat16
        assert np.array_equal(g["tokens"], want["tokens"])
        for t in (g["enc_embed"], o["enc_embed"]):
            assert np.array_equal(t.float().numpy(),
                                  want["enc_embed"].astype(np.float32))
    assert next(launch_train.with_extras(iter([{"a": 1}]), {})) == {"a": 1}


def test_zamba2_steps_with_a_zero_gradient_for_an_unread_parameter():
    """zamba2's shared-block layers hold a ``norm1`` that nothing reads
    (the shared weights live in ``LM.shared_attn``): its gradient is zero,
    as ``jax.grad`` gives it, where autograd alone would refuse the step."""
    pc = preg.reduced_config("zamba2-1.2b").replace(compute_dtype="float32")
    state = init_state(torch.Generator().manual_seed(0), pc, device="cpu")
    _, pb = _batch(pc, B=2)
    state, m = make_train_step(pc)(state, pb)
    assert np.isfinite(float(m["loss"])) and int(m["step"]) == 1
    moment = state.opt["m"]
    unread = [f"layers.{i}.norm1.scale" for i, spec in enumerate(pc.plan)
              if spec.kind == "shared_attn"]
    assert unread and all(not float(moment[n].abs().max()) for n in unread)
    assert pc.plan[0].kind != "shared_attn"
    assert float(moment["layers.0.norm1.scale"].abs().max()) > 0
