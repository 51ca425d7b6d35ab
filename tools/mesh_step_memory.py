"""A train step under a mesh over every card of the host, against the same
step on one card unsharded: peak device memory, the state's memory, step
wall time and the losses.

    PYTHONPATH=src python tools/mesh_step_memory.py [--batch 32] [--model 1 2 4]
    PYTHONPATH=src python tools/mesh_step_memory.py --predict 4 --model 1 2 4
    PYTHONPATH=src python tools/mesh_step_memory.py --arch deepseek-v2-lite-16b \
        --repeats 2 --model 2 4 [--plain-attention]
    PYTHONPATH=src python tools/mesh_step_memory.py --arch rwkv6-3b \
        --repeats 16 --batch 8 --predict 1 --model 1

The model is ``--arch`` at full width cut to its prologue and ``--repeats``
superblocks (default llama-3.2-vision-11b at one superblock: one ``xattn``
and four ``attn`` layers, ~1.6 B parameters; xgates 1.0), bf16 compute,
its optimizer, drawn from one seed on every card.  ``--plain-attention``
sets ``use_pallas="never"``: every layer runs its plain PyTorch version
(a package without a kernel's backward can then train the model, for an
A/B of the rest of the step).  Card 0 first runs
``--steps`` unsharded steps; then every card, one NCCL rank each, places
the same state on a (cards / N, N) ``("data", "model")`` mesh for each N of
``--model`` in turn with ``trainstep.shard_state`` and runs the same
steps: each microbatch's rows split over the ``data`` cards, the products
split over the ``model`` cards (tensor parallelism: the weights' splits
over ``model`` stay split).  Peaks are read after the state is placed, so
they count the state and the step.  Rank 0 prints one JSON line a run and
a summary a mesh; the script exits 1 if a mesh loss differs from the
unsharded one by more than ``LOSS_REL`` (bf16 rounds at other places when
a GEMM takes fewer rows or columns).  Needs at least two cards.  With
``--predict CARDS`` it runs no card: the dry run (``launch/dryrun.py``)
predicts each run's bytes a card on meta tensors on the CPU.
"""
from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time

import torch

LOSS_REL = 5e-2


def _cfg(arch="llama-3.2-vision-11b", repeats=1, plain=False):
    from repro_torch.configs import registry
    full = registry.get_config(arch)
    cfg = full.replace(n_repeat=repeats, n_layers=len(full.prologue)
                       + repeats * len(full.superblock))
    return cfg.replace(use_pallas="never") if plain else cfg


def _optimizer(cfg):
    """The config's optimizer at lr 3e-4."""
    from repro_torch.train.optimizer import make_optimizer
    return make_optimizer(cfg.optimizer, lr=3e-4, cfg=cfg)


def _state(cfg, opt, dev):
    from repro_torch.train.trainstep import init_state
    state = init_state(torch.Generator(device=dev).manual_seed(0), cfg, opt)
    with torch.no_grad():
        for layer, spec in zip(state.params.layers, cfg.plan):
            if spec.kind == "xattn":
                layer.xgate.fill_(1.0)
    return state


def _batches(cfg, batch, steps, seq=128):
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import with_extras
    extras = {}
    if cfg.n_img_tokens:
        extras["img_embed"] = ((batch, cfg.n_img_tokens, cfg.d_vision),
                               "bfloat16")
    if cfg.n_enc_layers:
        extras["enc_embed"] = ((batch, cfg.enc_len, cfg.d_model), "bfloat16")
    data = with_extras(SyntheticTokens(batch, seq, cfg.vocab_size), extras)
    return [next(data) for _ in range(steps)]


def _run(step, state, batches, dev):
    """Losses and wall ms of each step; the peak since the state was
    placed and the bytes the placed state holds."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, ms = [], []
    for b in batches:
        t0 = time.monotonic()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        ms.append(1e3 * (time.monotonic() - t0))
    return {"losses": losses, "step_ms": ms, "state_bytes": held,
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}


def rank_main(rank, world, port, batch, steps, models, out_path, cfg_args,
              seq):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.train.trainstep import make_train_step, shard_state
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world, device_id=dev)
    try:
        cfg = _cfg(*cfg_args)
        opt = _optimizer(cfg)
        batches = _batches(cfg, batch, steps, seq)
        runs = {}
        if rank == 0:
            state = _state(cfg, opt, dev)
            runs["unsharded"] = _run(make_train_step(cfg, opt), state,
                                     batches, dev)
            del state
        dist.barrier()
        for model in models:
            shape = (world // model, model)
            mesh = init_device_mesh("cuda", shape,
                                    mesh_dim_names=("data", "model"))
            state = shard_state(_state(cfg, opt, dev), mesh)
            run = _run(make_train_step(cfg, opt, mesh), state, batches, dev)
            run["mesh_shape"] = list(shape)
            run["params"] = sum(p.numel() for p in state.params.parameters())
            del state
            mine = torch.tensor([run["peak_bytes"], run["state_bytes"]],
                                device=dev)
            gathered = [torch.zeros_like(mine) for _ in range(world)]
            dist.all_gather(gathered, mine)
            run["peak_bytes_by_rank"] = [int(g[0]) for g in gathered]
            run["state_bytes_by_rank"] = [int(g[1]) for g in gathered]
            runs[f"mesh_{shape[0]}x{shape[1]}"] = run
            torch.cuda.empty_cache()
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(runs, f)
    finally:
        dist.destroy_process_group()


def predict(cards, batch, models, out, cfg_args, seq=128) -> int:
    """The dry run's prediction of the same steps on meta tensors, on this
    host's CPU: a fake group of ``cards`` ranks, each (cards / N, N) mesh
    of ``models`` (``--predict 1 --model 1`` stands for one card): per card the
    argument bytes (state + batch), the peak of saved bytes, the peak of
    live tensors, and argument + live as the predicted peak."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    cfg = _cfg(*cfg_args)
    shape = ShapeConfig("mesh_step_memory", "train", seq, batch)
    dryrun.fake_group(cards)
    rows = []
    for model in models:
        dims = (cards // model, model)
        mesh = DeviceMesh("cpu", torch.arange(dims[0] * dims[1]).reshape(dims),
                          mesh_dim_names=("data", "model"))
        info = dryrun.analyze(dryrun.lower_cell(cfg.arch_id, shape, mesh,
                                                cfg=cfg))
        mem = info["memory"]
        rows.append({"run": f"mesh_{dims[0]}x{dims[1]}",
                     "mesh_shape": list(dims),
                     "argument_gb": mem["argument_bytes"] / 1e9,
                     "saved_peak_gb": mem["temp_bytes"] / 1e9,
                     "live_peak_gb": mem["peak_live_bytes"] / 1e9,
                     "predicted_peak_gb": (mem["argument_bytes"]
                                           + mem["peak_live_bytes"]) / 1e9,
                     "flops": info["flops"],
                     "collective_bytes": info["collectives"]})
        print(json.dumps(rows[-1]), flush=True)
    with open(out, "w") as f:
        json.dump(rows, f)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--model", type=int, nargs="+", default=[1],
                    help="model-axis sizes, one (cards / N, N) mesh each")
    ap.add_argument("--out", default="mesh_step_memory.json")
    ap.add_argument("--predict", type=int, metavar="CARDS", default=None,
                    help="no card: print the dry run's prediction for "
                         "CARDS cards on the CPU")
    ap.add_argument("--arch", default="llama-3.2-vision-11b")
    ap.add_argument("--repeats", type=int, default=1,
                    help="superblock repeats after the prologue")
    ap.add_argument("--plain-attention", action="store_true",
                    help="use_pallas='never': plain versions, no kernels")
    args = ap.parse_args(argv)
    cfg_args = (args.arch, args.repeats, args.plain_attention)
    if args.predict:
        return predict(args.predict, args.batch, args.model, args.out,
                       cfg_args, args.seq)
    world = torch.cuda.device_count()
    if world < 2:
        print("mesh_step_memory: needs at least two cards", file=sys.stderr)
        return 2
    if any(world % n for n in args.model):
        ap.error(f"every --model size must divide the {world} cards")
    from repro_torch.kernels import _build
    _build.build_all()  # once, before the ranks start
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.multiprocessing.spawn(rank_main, args=(world, port, args.batch,
                                                 args.steps, args.model,
                                                 args.out, cfg_args,
                                                 args.seq),
                                nprocs=world)
    runs = json.load(open(args.out))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    for label, run in runs.items():
        print(json.dumps({"run": label, **run}))
    worst = 0.0
    for label, run in runs.items():
        if label == "unsharded":
            continue
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            run["losses"], runs["unsharded"]["losses"]))
        worst = max(worst, rel)
        print(json.dumps({
            "arch": args.arch, "repeats": args.repeats,
            "plain_attention": args.plain_attention,
            "cards": world, "card": card, "batch": args.batch,
            "seq": args.seq,
            "mesh_shape": run["mesh_shape"], "loss_rel": rel,
            "loss_rel_bar": LOSS_REL,
            "peak_gb_unsharded": runs["unsharded"]["peak_bytes"] / 1e9,
            "peak_gb_mesh_max": max(run["peak_bytes_by_rank"]) / 1e9,
            "state_gb_mesh_max": max(run["state_bytes_by_rank"]) / 1e9,
            "warm_step_ms": run["step_ms"][-1]}))
    return 0 if worst <= LOSS_REL else 1


if __name__ == "__main__":
    sys.exit(main())
