"""Run a function on several gloo ranks of ``torch.distributed``, each in a
spawned process, for the CPU tests of the port's sharding, collectives and
elastic restore.

``spawn(fn, world, tmp, timeout, *args)`` starts ``world`` processes that
join one process group through a file store under ``tmp`` and call
``fn(rank, world, tmp, *args)``; it waits at most ``timeout`` seconds in
all, stops any process still running, and raises unless every rank exited
with 0.  Results travel through files under ``tmp``.  The rank functions
below are what the tests run.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import time
import traceback
import warnings

import numpy as np


def _main(fn, rank, world, tmp, args):
    import torch
    import torch.distributed as dist
    warnings.filterwarnings("ignore")
    # one thread a rank: 8 ranks of a full thread pool each would crowd out
    # the other test workers on the same cores
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, tmp, *args)
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp: str, timeout: float, *args) -> None:
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_main, args=(fn, r, world, str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    errors = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
              if f.startswith("error_")]
    codes = [p.exitcode for p in procs]
    if errors or any(c != 0 for c in codes):
        raise RuntimeError(f"rank exit codes {codes}\n" + "\n".join(errors))


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def collectives_rank(rank, world, tmp, inputs):
    """``compressed_grad_allreduce`` over a 1-D ``data`` mesh of all ranks on
    each input (leading dim: one partial gradient a rank), and
    ``int8_psum`` over the whole group; then, on a (2, world/2) mesh, the
    global (row, col) offset of the block each rank holds under each spec."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.collectives import (compressed_grad_allreduce,
                                                  int8_psum)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    out = {}
    for name, arr in np.load(inputs).items():
        g = distribute_tensor(torch.from_numpy(arr.copy()), mesh, [Shard(0)])
        out[name] = compressed_grad_allreduce({"w": g}, mesh)["w"].numpy()
        local = torch.from_numpy(arr[rank].copy())
        out[f"{name}_psum"] = int8_psum(local).numpy()
    mesh2 = init_device_mesh("cpu", (2, world // 2),
                             mesh_dim_names=("data", "model"))
    full = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    for key, spec in SPECS.items():
        t = distribute_tensor(full, mesh2, shd.placements(shd.P(*spec), mesh2))
        loc = t.to_local()
        out[f"block_{key}"] = np.array([int(loc[0, 0]) // 8,
                                        int(loc[0, 0]) % 8, *loc.shape])
    np.savez(os.path.join(tmp, f"out_{rank}.npz"), **out)


# specs whose blocks the ranks report, as the reference's devices see them
SPECS = {"rows_data_model": (("data", "model"), None),
         "data_by_model": ("data", "model"),
         "model_rows": ("model", None)}


# the stepped parameters the elastic rescale holds whole: the vocab-split
# embedding (its gradient gathers other ranks' rows), an fsdp x tensor
# projection and a replicated norm
ELASTIC_LEAVES = ("embed", "layers.0.attn.wq", "final_norm.scale")


def elastic_rank(rank, world, tmp, cfg_over, lr, batch_path):
    """The elastic rescale: restore the checkpoint under ``tmp/work`` (saved
    unsharded at step 2) onto a (2, world/2) mesh through the Trainer and
    take one step, then evaluate the batch on the new parameters; rank 0
    writes the losses, the step's gradient norm and what it restored, and
    ``ELASTIC_LEAVES`` after the step, gathered whole."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import registry
    from repro_torch.train.trainer import Trainer
    from repro_torch.train.trainstep import make_eval_step
    cfg = registry.reduced_config("granite-3-8b").replace(**cfg_over)
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("data", "model"))
    batch = dict(np.load(batch_path))
    tr = Trainer(cfg, os.path.join(tmp, "work"), iter([batch]), mesh=mesh,
                 lr=lr, device="cpu")
    state = tr.restore_or_init()
    params = dict(state.params.named_parameters())
    placed = {k: [str(p) for p in v.placements] for k, v in params.items()
              if isinstance(v, DTensor)}
    step = int(state.step)
    seen = []
    step_fn = tr.step_fn

    def keep_metrics(*args):
        out = step_fn(*args)
        seen.append(out[1])
        return out
    tr.step_fn = keep_metrics
    state = tr.train(3, state)
    evaluated = make_eval_step(cfg, mesh)(state.params, batch)
    stepped = {k: v.full_tensor().detach().numpy() for k, v in
               state.params.named_parameters() if k in ELASTIC_LEAVES}
    if rank == 0:
        np.savez(os.path.join(tmp, "elastic_leaves.npz"), **stepped)
        with open(os.path.join(tmp, "elastic.json"), "w") as f:
            json.dump({"restored_step": step, "steps": int(state.step),
                       "loss": tr.history[-1]["loss"],
                       "grad_norm": float(seen[-1]["grad_norm"]),
                       "eval_loss": float(evaluated["loss"]),
                       "n_params": len(params), "placements": placed,
                       "saved": tr.ckpt.latest_step(),
                       "opt_is_dtensor": isinstance(
                           next(iter(state.opt["m"].values())), DTensor),
                       "device": str(torch.device(mesh.device_type))}, f)


def mesh_train_rank(rank, world, tmp, archs, steps):
    """For each arch (reduced, float32 compute, xgates 1.0): ``steps``
    train steps on a (2, world/2) mesh from ``shard_state`` of a seeded
    state, and the same steps unsharded; rank 0 writes both runs' losses
    and gradient norms, the stepped ``embed`` and ``layers.0.*``
    parameters, and, over every layer call (``with_gathered_params``), the
    most parameters gathered outside that layer: those an earlier layer
    under remat gathered and are still alive, and the other layers' split
    weights no longer split."""
    import weakref

    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import with_extras
    from repro_torch.models import lm
    from repro_torch.train.trainstep import (init_state, make_train_step,
                                             shard_state)
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("data", "model"))
    gathered, most, prologue = [], [0], set()
    split, model = set(), [None]
    real = lm.with_gathered_params

    def spy(module, fn, *args):
        own = {id(p) for p in module.parameters()}  # nothing to gather

        def run(m, *a):
            most[0] = max(most[0], sum(r() is not None for r in gathered))
            # the other layers' split weights are still split
            mine = {id(p) for p in m.parameters()}
            most[0] = max(most[0], sum(
                1 for k, p in model[0].named_parameters()
                if k in split and id(p) not in mine
                and not any(isinstance(q, Shard) for q in p.placements)))
            # a prologue layer runs outside remat (as the reference's), so
            # its backward keeps what it gathered
            gathered[:] = ([] if id(module) in prologue
                           else [weakref.ref(p) for p in m.parameters()
                                 if id(p) not in own])
            return fn(m, *a)
        return real(module, run, *args)
    lm.with_gathered_params = spy
    out = {}
    for arch in archs:
        cfg = registry.reduced_config(arch).replace(compute_dtype="float32",
                                                    microbatch=2)
        extras = {}
        if cfg.n_enc_layers:
            extras["enc_embed"] = ((8, cfg.enc_len, cfg.d_model), "bfloat16")
        if cfg.n_img_tokens:
            extras["img_embed"] = ((8, cfg.n_img_tokens, cfg.d_vision),
                                   "bfloat16")
        data = SyntheticTokens(8, 16, cfg.vocab_size)
        batches = list(with_extras((data.batch_at(i) for i in range(steps)),
                                   extras))
        for label in ("plain", "mesh"):
            opt = step_optimizer(cfg)
            state = init_state(torch.Generator().manual_seed(0), cfg, opt,
                               "cpu")
            with torch.no_grad():
                for name, p in state.params.named_parameters():
                    if name.endswith("xgate"):
                        p.fill_(1.0)  # tanh(0) would hide the layer
            prologue.clear()
            prologue.update(id(m) for m in
                            state.params.layers[:len(cfg.prologue)])
            model[0] = state.params
            split.clear()
            gathered.clear()
            use = mesh if label == "mesh" else None
            if use is not None:
                state = shard_state(state, mesh)
                # outside the step's rules too (a recompute on autograd's
                # device thread): a layer's weights arrive gathered over
                # every mesh dim but model, and split over model as placed
                last = state.params.layers[-1]
                seen = real(last, lambda m: [list(p.placements)
                                             for p in m.parameters()])
                want = [[q if name == "model" else Replicate()
                         for name, q in zip(mesh.mesh_dim_names,
                                            p.placements)]
                        for p in last.parameters()]
                out[f"{arch}/gathered_outside_rules"] = seen == want
                model[0] = state.params
                split.clear()
                split.update(k for k, p in state.params.named_parameters()
                             if k.startswith("layers.") and any(
                                 isinstance(q, Shard) for q in p.placements))
            step = make_train_step(cfg, opt, use)
            most[0], metrics = 0, []
            for b in batches:
                state, m = step(state, b)
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
            leaves = {k: (p.full_tensor() if use is not None else p)
                      .detach().numpy()
                      for k, p in state.params.named_parameters()
                      if k == "embed" or k.startswith("layers.0.")}
            out[f"{arch}/{label}"] = {"metrics": metrics,
                                      "still_whole": most[0]}
            if rank == 0:
                np.savez(os.path.join(tmp, f"{arch}_{label}.npz"), **leaves)
    if rank == 0:
        with open(os.path.join(tmp, "mesh_train.json"), "w") as f:
            json.dump(out, f)


def step_optimizer(cfg):
    """The optimizer of the mesh-against-unsharded step tests: the
    config's, at lr 1e-3, AdamW with eps 1e-3.  Under tensor parallelism
    the mesh step sums in another order than the unsharded one (float32
    noise of ~1e-7 a layer); at eps 1e-8 AdamW's second step divides a
    momentum that nearly cancels by its own size, which turns that noise
    into ~1e-4 in zero-initialized norm scales.  At eps 1e-3 each update
    is a smooth function of its gradient, so the stepped parameters
    measure the step."""
    from repro_torch.train.optimizer import make_optimizer
    kw = {"eps": 1e-3} if cfg.optimizer == "adamw" else {}
    return make_optimizer(cfg.optimizer, lr=1e-3, cfg=cfg, **kw)


def _seeded_state(cfg, opt, torch):
    from repro_torch.train.trainstep import init_state
    state = init_state(torch.Generator().manual_seed(0), cfg, opt, "cpu")
    with torch.no_grad():
        for name, p in state.params.named_parameters():
            if name.endswith("xgate"):
                p.fill_(1.0)  # tanh(0) would hide the layer
    return state


def _batches(cfg, batch, seq, steps):
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import with_extras
    extras = {}
    if cfg.n_enc_layers:
        extras["enc_embed"] = ((batch, cfg.enc_len, cfg.d_model), "bfloat16")
    if cfg.n_img_tokens:
        extras["img_embed"] = ((batch, cfg.n_img_tokens, cfg.d_vision),
                               "bfloat16")
    data = SyntheticTokens(batch, seq, cfg.vocab_size)
    return list(with_extras((data.batch_at(i) for i in range(steps)), extras))


def _spy_model_gathers(torch, model_dim):
    """Record the global shape of every tensor DTensor all-gathers over
    mesh dim ``model_dim`` (a Shard there redistributed to anything but
    the same Shard), whether asked for (``redistribute``) or implicit (an
    op's sharding propagation): returns the list it appends to."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor import _dispatch, _redistribute
    seen = []
    real = _redistribute.redistribute_local_tensor

    def spy(local, current, target, *args, **kwargs):
        a, b = current.placements[model_dim], target.placements[model_dim]
        if isinstance(a, Shard) and a != b:
            seen.append(tuple(current.shape))
        return real(local, current, target, *args, **kwargs)
    _redistribute.redistribute_local_tensor = spy
    _dispatch.redistribute_local_tensor = spy
    return seen


def tensor_parallel_rank(rank, world, tmp, cases, shapes, steps, batch,
                         seq):
    """For each case (label, arch, config overrides): ``steps`` train steps
    (reduced config, float32) unsharded on rank 0, then on each mesh of
    ``shapes`` ("data", "model") from ``shard_state`` of the same seeded
    state, with an eval step before each step; rank 0 writes every run's
    metrics and stepped parameters (``<label>_<run>.npz``, run "plain" or
    the mesh's "DxM"), and for each mesh the global shapes of the tensors
    all-gathered over ``model`` during its steps, the shapes of the weights
    split over ``model`` and the local head counts each call of the flash
    and WKV6 dispatch received (and the MoE groups each rank routed)
    (``tp.json``)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.train.trainstep import (make_eval_step, make_train_step,
                                             shard_state)
    meshes = {f"{a}x{b}": init_device_mesh("cpu", (a, b),
                                           mesh_dim_names=("data", "model"))
              for a, b in shapes}
    gathers = _spy_model_gathers(torch, 1)
    heads = {"flash": [], "wkv6": [], "moe_groups": []}
    flash, wkv, route = ops._flash_local, ops._wkv6_scan, moe._route

    def route_spy(p, xf, cfg, n_tokens=None):
        if n_tokens is not None:  # under the mesh: (groups here, in all)
            heads["moe_groups"].append([xf.shape[0], n_tokens // xf.shape[1]])
        return route(p, xf, cfg, n_tokens)

    def flash_spy(q, k, v, *a):
        heads["flash"].append([q.shape[2], k.shape[2]])
        return flash(q, k, v, *a)

    def wkv_spy(r, *a, **kw):
        heads["wkv6"].append([r.shape[2]])
        return wkv(r, *a, **kw)
    moe._route = route_spy
    ops._flash_local, ops._wkv6_scan = flash_spy, wkv_spy
    out = {}
    for label, arch, over in cases:
        cfg = registry.reduced_config(arch).replace(
            compute_dtype="float32", param_dtype="float32",
            accum_dtype="float32", microbatch=2, **over)
        rules = registry.arch_rules(arch)
        batches = _batches(cfg, batch, seq, steps)
        res = {"n_heads": [cfg.n_heads, cfg.n_kv_heads,
                           cfg.d_model // cfg.rwkv_head_dim]}
        # the unsharded run needs no collective: rank 0 alone runs it
        for run, mesh in [("plain", None)] + list(meshes.items()):
            if mesh is None and rank != 0:
                continue
            opt = step_optimizer(cfg)
            state = _seeded_state(cfg, opt, torch)
            if mesh is not None:
                state = shard_state(state, mesh, rules)
                res[f"split/{run}"] = sorted(
                    {tuple(p.shape) for k, p in state.params.named_parameters()
                     if isinstance(p.placements[1], Shard)
                     and "experts" not in k})
                del gathers[:]
                for key in heads:
                    heads[key].clear()
            step = make_train_step(cfg, opt, mesh, rules)
            evaluate = make_eval_step(cfg, mesh, rules)
            metrics = []
            for b in batches:
                ev = evaluate(state.params, b)
                state, m = step(state, b)
                metrics.append([float(m["loss"]), float(m["grad_norm"]),
                                float(ev["loss"]), float(ev["moe_lb_loss"]),
                                float(ev["moe_z_loss"])])
            res[run] = metrics
            if mesh is not None:  # before the parameters are gathered below
                res[f"gathered/{run}"] = sorted(set(gathers))
                res[f"heads/{run}"] = {k: v[:] for k, v in heads.items()}
            leaves = {k: (p.full_tensor() if mesh is not None else p)
                      .detach().numpy()
                      for k, p in state.params.named_parameters()}
            if rank == 0:
                np.savez(os.path.join(tmp, f"{label}_{run}.npz"), **leaves)
        out[label] = res
    if rank == 0:
        with open(os.path.join(tmp, "tp.json"), "w") as f:
            json.dump(out, f)


def serve_mesh_rank(rank, world, tmp, cases, shape, batch, prompt, steps):
    """For each case (label, arch, config overrides, rules or None):
    prefill + ``steps`` greedy decode steps through ``make_prefill_fn`` /
    ``make_decode_fn`` on a ``shape`` mesh (parameters placed by
    ``shard_module``) and unsharded, and ``ServeEngine.generate`` both
    ways (float32 caches and compute); rank 0 writes every step's logits
    (``<label>_<run>.npz``), the generated tokens and the caches'
    placements (``serve.json``)."""
    import copy

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve.engine import (ServeEngine, extra_shapes,
                                          make_decode_fn, make_prefill_fn)
    mesh = init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=("data", "model"))
    out = {}
    for label, arch, over in cases:
        cfg = registry.reduced_config(arch).replace(
            compute_dtype="float32", **over)
        rules = registry.arch_rules(arch)
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with torch.no_grad():
            for name, p in params.named_parameters():
                if name.endswith("xgate"):
                    p.fill_(1.0)
        g = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g)
        extra = [torch.randn(s, generator=g).to(torch.bfloat16)
                 for s in extra_shapes(cfg, batch).values()]
        res = {}
        for run in ("plain", "mesh"):
            use = mesh if run == "mesh" else None
            if use is None and rank != 0:  # no collective: rank 0 alone
                continue
            model = copy.deepcopy(params)
            if use is not None:
                shd.shard_module(model, mesh, rules)
            max_len = prompt + steps + 1
            prefill = make_prefill_fn(cfg, max_len, use, rules,
                                      cache_dtype=torch.float32)
            decode = make_decode_fn(cfg, use, rules)
            with torch.inference_mode():
                logits, caches = prefill(model, toks, *extra)
                logs = [logits[:, -1]]
                for _ in range(steps):
                    tok = torch.argmax(_whole(logs[-1]), -1)[:, None]
                    logits, caches = decode(model, tok, caches)
                    logs.append(logits)
                eng = ServeEngine(cfg, model, max_len=max_len,
                                  cache_dtype=torch.float32, mesh=use,
                                  rules=rules)
                gen = eng.generate(toks, steps + 1, dict(zip(
                    extra_shapes(cfg, batch), extra)))
            whole = [_whole(x).numpy() for x in logs]  # every rank gathers
            if rank == 0:
                np.savez(os.path.join(tmp, f"{label}_{run}.npz"), *whole)
            res[run] = {"tokens": gen.tolist(), "caches": sorted({
                f"{k}:{','.join(_placement(p) for p in v.placements)}"
                for c in caches["layers"] for k, v in c.items()
                if hasattr(v, "placements")})}
        out[label] = res
    if rank == 0:
        with open(os.path.join(tmp, "serve.json"), "w") as f:
            json.dump(out, f)


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _placement(p):
    """S<dim> for a split, R for a replica (placements print differently
    across torch versions)."""
    return f"S{p.dim}" if hasattr(p, "dim") else "R"
