"""The port on the meta device, against the reference's shapes.

A meta tensor has a shape and a dtype and no data.  The kernel dispatch
(``kernels/ops.py``) takes the plain versions on every device but a card,
as the reference takes its plain path on every device but a TPU, so a
prefill, a decode step and a training step's forward and backward run on
meta tensors.  Each output is a meta tensor of the shape
``jax.eval_shape`` gives for the reference's function on the same config.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.train.trainstep import init_state as jinit
from repro.train.trainstep import make_train_step as jmake_step
from repro_torch.configs import registry as preg
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.serve.engine import extra_shapes
from repro_torch.train.trainstep import init_state, make_train_step

ARCHS = ["jag-surrogate", "whisper-tiny", "rwkv6-3b"]
B, S, MAX_LEN = 2, 8, 12
META = torch.device("meta")


def _meta_model(arch):
    cfg = preg.reduced_config(arch)
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(0), META)


def _meta_extras(cfg, batch=B):
    return {k: torch.empty(s, dtype=torch.bfloat16, device=META)
            for k, s in extra_shapes(cfg, batch).items()}


def _ref_setup(arch):
    cfg = jreg.reduced_config(arch)
    params = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    extra = {k: jax.ShapeDtypeStruct(s, jnp.bfloat16)
             for k, s in extra_shapes(preg.reduced_config(arch), B).items()}
    return cfg, params, tok, extra


def _assert_meta(got, want):
    assert got.device.type == "meta"
    assert tuple(got.shape) == tuple(want.shape)


def test_flash_attention_on_meta_returns_meta():
    q = torch.empty(2, 5, 4, 32, dtype=torch.bfloat16, device=META)
    k = torch.empty(2, 7, 2, 32, dtype=torch.bfloat16, device=META)
    for causal in (True, False):
        out = ops.flash_attention(q, k, k, causal=causal)
        assert out.device.type == "meta" and out.shape == q.shape
        assert out.dtype == q.dtype


def test_scans_on_meta_return_meta():
    r = torch.empty(1, 20, 2, 32, device=META)
    u = torch.empty(2, 32, device=META)
    assert ops.wkv6_scan(r, r, r, r, u, chunk=16).shape == r.shape
    x = torch.empty(1, 20, 2, 32, device=META)
    dt = torch.empty(1, 20, 2, device=META)
    Bm = torch.empty(1, 20, 1, 16, device=META)
    y = ops.ssd_scan(x, dt, torch.empty(2, device=META), Bm, Bm, chunk=16)
    assert y.device.type == "meta" and y.shape == x.shape


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_meta(arch):
    jcfg, jparams, jtok, jextra = _ref_setup(arch)
    want_pre, want_caches = jax.eval_shape(
        lambda p, t, e: jlm.prefill(p, t, jcfg, max_len=MAX_LEN, extra=e),
        jparams, jtok, jextra)
    want_dec, _ = jax.eval_shape(
        lambda p, t, c: jlm.decode_step(p, t, c, jcfg), jparams,
        jax.ShapeDtypeStruct((B, 1), jnp.int32), want_caches)
    cfg, model = _meta_model(arch)
    tok = torch.empty(B, S, dtype=torch.int32, device=META)
    with torch.no_grad():
        logits, caches = lm.prefill(model, tok, cfg, max_len=MAX_LEN,
                                    extra=_meta_extras(cfg))
        _assert_meta(logits, want_pre)
        step_logits, caches = lm.decode_step(model, tok[:, :1], caches, cfg)
    _assert_meta(step_logits, want_dec)
    assert caches["pos"] == S + 1
    for layer in caches["layers"]:
        for t in layer.values():
            assert t.device.type == "meta"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_meta(arch):
    """The forward (loss) and backward (every gradient) of one training
    step, then the whole step through ``make_train_step``: meta tensors of
    the reference's shapes."""
    jcfg, jparams, jtok, jextra = _ref_setup(arch)
    jbatch = {"tokens": jtok, "labels": jtok, **jextra}
    want_loss, want_grads = jax.eval_shape(
        lambda p, b: jax.value_and_grad(
            lambda q: jlm.loss_fn(q, b, jcfg)[0])(p), jparams, jbatch)
    cfg, model = _meta_model(arch)
    tok = torch.empty(B, S, dtype=torch.int32, device=META)
    batch = {"tokens": tok, "labels": tok, **_meta_extras(cfg)}
    loss, _ = lm.loss_fn(model, batch, cfg)
    _assert_meta(loss, want_loss)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    # the reference stacks layers over n_repeat (and whisper's encoder over
    # n_enc_layers) where the port holds one tensor a layer: same numbers
    assert sum(g.numel() for g in grads) == sum(
        int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(want_grads))
    for (name, p), g in zip(params.items(), grads):
        assert g.device.type == "meta" and g.shape == p.shape, name

    want_state = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    _, want_m = jax.eval_shape(jmake_step(jcfg), want_state, jbatch)
    state = init_state(torch.Generator().manual_seed(0), cfg, device=META)
    state, metrics = make_train_step(cfg)(state, batch)
    for key in ("loss", "grad_norm", "step"):
        _assert_meta(metrics[key], want_m[key])
    assert all(m.device.type == "meta" for m in state.opt["m"].values())
