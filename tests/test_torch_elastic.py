"""The elastic rescale (``tests/test_elastic.py``) on the port: a train
state saved unsharded resumes on a (2, 4) mesh of 8 gloo ranks, through
``Trainer(mesh=)`` and ``restore(..., shardings=param_spec_tree(...))``,
and its next step's loss is the unsharded continuation's.

The state comes from the reference: its reduced granite-3-8b config (as
``tests/test_elastic.py`` cuts it), two of its training steps, then its
third step's loss.  float32 compute on both sides, since bf16 rounds at
other places in the two frameworks: the port's unsharded third step and
the reference's must each agree with the sharded one within rel 1e-3, and
so must ``make_eval_step`` under the mesh with the unsharded one on the
stepped parameters.  The loss before the update and AdamW's scale-free
step would hide a gradient off by a factor, so the step's gradient norm
and three stepped parameters (``_torch_dist.ELASTIC_LEAVES``) are held to
the port's unsharded step within rel 1e-5 (float32; only the order of the
sums differs), and the gradient norm to the reference's within 1e-4.
"""
import json

import jax
import numpy as np
from torch.distributed.tensor import Replicate, Shard

import _torch_dist
from repro.configs import registry as jreg
from repro.data.pipeline import SyntheticTokens
from repro.train.optimizer import make_optimizer as jmake_opt
from repro.train.trainstep import init_state as jinit
from repro.train.trainstep import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import registry as preg
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.trainer import state_tree
from repro_torch.train.trainstep import make_eval_step, make_train_step

CFG = dict(d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
           vocab_size=512, microbatch=2, compute_dtype="float32")
LR = 1e-3


def test_elastic_rescale_on_a_2x4_mesh(tmp_path):
    jcfg = jreg.reduced_config("granite-3-8b").replace(**CFG)
    opt = jmake_opt(jcfg.optimizer, lr=LR)
    state = jinit(jax.random.PRNGKey(0), jcfg, opt)
    data = SyntheticTokens(8, 16, jcfg.vocab_size)
    step = jax.jit(jmake_step(jcfg, opt))
    for i in range(2):
        state, _ = step(state, data.batch_at(i))
    state_np = jax.tree.map(np.asarray, tuple(state))
    _, ref_m = step(state, data.batch_at(2))
    ref_loss, ref_gnorm = float(ref_m["loss"]), float(ref_m["grad_norm"])

    pcfg = preg.reduced_config("granite-3-8b").replace(**CFG)
    pstate = convert.train_state_from_jax(state_np, pcfg, "cpu")
    ckpt = CheckpointManager(str(tmp_path / "work" / "ckpt"),
                             async_save=False)
    ckpt.save(2, state_tree(pstate))
    batch = data.batch_at(2)
    np.savez(tmp_path / "batch.npz", **batch)
    _, m = make_train_step(pcfg, make_optimizer(pcfg.optimizer, lr=LR))(
        pstate, batch)
    port_loss, port_gnorm = float(m["loss"]), float(m["grad_norm"])
    port_leaves = {k: v.detach().numpy() for k, v in
                   pstate.params.named_parameters()
                   if k in _torch_dist.ELASTIC_LEAVES}
    port_eval = float(make_eval_step(pcfg)(pstate.params, batch)["loss"])

    _torch_dist.spawn(_torch_dist.elastic_rank, 8, str(tmp_path), 240, CFG,
                      LR, str(tmp_path / "batch.npz"))
    out = json.loads((tmp_path / "elastic.json").read_text())
    assert out["restored_step"] == 2 and out["steps"] == 3
    assert out["saved"] == 3  # the sharded state, gathered and written
    assert out["opt_is_dtensor"]
    # every parameter lives on the mesh, placed by its spec
    assert len(out["placements"]) == out["n_params"]
    fsdp_tensor = [str(Shard(0)), str(Shard(1))]
    assert out["placements"]["layers.0.attn.wq"] == fsdp_tensor
    assert out["placements"]["final_norm.scale"] == [str(Replicate())] * 2
    loss = out["loss"]
    assert abs(loss - port_loss) / port_loss < 1e-3, (loss, port_loss)
    assert abs(loss - ref_loss) / ref_loss < 1e-3, (loss, ref_loss)
    # make_eval_step under the mesh, on the stepped parameters
    assert abs(out["eval_loss"] - port_eval) / port_eval < 1e-3
    gnorm = out["grad_norm"]
    assert abs(gnorm - port_gnorm) / port_gnorm < 1e-5, (gnorm, port_gnorm)
    assert abs(gnorm - ref_gnorm) / ref_gnorm < 1e-4, (gnorm, ref_gnorm)
    stepped = np.load(tmp_path / "elastic_leaves.npz")
    assert set(stepped.files) == set(port_leaves)
    for k, want in port_leaves.items():
        rel = np.linalg.norm(stepped[k] - want) / np.linalg.norm(want)
        assert rel < 1e-5, (k, rel)
