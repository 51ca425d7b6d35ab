"""A train step under a data mesh over every card of the host, against the
same step on one card unsharded: peak device memory, the state's memory,
step wall time and the losses.

    PYTHONPATH=src python tools/mesh_step_memory.py [--batch 32]

The model is llama-3.2-vision-11b at full width cut to one superblock (one
``xattn`` and four ``attn`` layers, ~1.6 B parameters; xgates 1.0), bf16
compute, AdamW, drawn from one seed on every card.  Card 0 first runs
``--steps`` unsharded steps; then every card, one NCCL rank each, places
the same state on a (cards, 1) ``("data", "model")`` mesh with
``trainstep.shard_state`` and runs the same steps, each microbatch's rows
split over the cards.  Peaks are read after the state is placed, so they
count the state and the step.  Rank 0 prints one JSON line a run and a
summary; the script exits 1 if a mesh loss differs from the unsharded one
by more than ``LOSS_REL`` (bf16 rounds at other places when a GEMM takes
fewer rows).  Needs at least two cards.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch

LOSS_REL = 5e-2


def _cfg():
    from repro_torch.configs import registry
    full = registry.get_config("llama-3.2-vision-11b")
    return full.replace(n_repeat=1, n_layers=len(full.superblock))


def _state(cfg, opt, dev):
    from repro_torch.train.trainstep import init_state
    state = init_state(torch.Generator(device=dev).manual_seed(0), cfg, opt)
    with torch.no_grad():
        for layer, spec in zip(state.params.layers, cfg.plan):
            if spec.kind == "xattn":
                layer.xgate.fill_(1.0)
    return state


def _batches(cfg, batch, steps):
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import with_extras
    data = with_extras(SyntheticTokens(batch, 128, cfg.vocab_size),
                       {"img_embed": ((batch, cfg.n_img_tokens, cfg.d_vision),
                                      "bfloat16")})
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


def rank_main(rank, world, port, batch, steps, out_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.trainstep import make_train_step, shard_state
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world, device_id=dev)
    try:
        cfg = _cfg()
        opt = make_optimizer(cfg.optimizer, lr=3e-4)
        batches = _batches(cfg, batch, steps)
        runs = {}
        if rank == 0:
            state = _state(cfg, opt, dev)
            runs["unsharded"] = _run(make_train_step(cfg, opt), state,
                                     batches, dev)
            del state
        dist.barrier()
        mesh = init_device_mesh("cuda", (world, 1),
                                mesh_dim_names=("data", "model"))
        state = shard_state(_state(cfg, opt, dev), mesh)
        runs["mesh"] = _run(make_train_step(cfg, opt, mesh), state, batches,
                            dev)
        runs["mesh"]["params"] = sum(p.numel()
                                     for p in state.params.parameters())
        peaks = torch.tensor([runs["mesh"]["peak_bytes"]], device=dev)
        gathered = [torch.zeros_like(peaks) for _ in range(world)]
        dist.all_gather(gathered, peaks)
        runs["mesh"]["peak_bytes_by_rank"] = [int(p) for p in gathered]
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(runs, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default="mesh_step_memory.json")
    args = ap.parse_args(argv)
    world = torch.cuda.device_count()
    if world < 2:
        print("mesh_step_memory: needs at least two cards", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build_all()  # once, before the ranks start
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.multiprocessing.spawn(rank_main, args=(world, port, args.batch,
                                                 args.steps, args.out),
                                nprocs=world)
    runs = json.load(open(args.out))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    for label, run in runs.items():
        print(json.dumps({"run": label, **run}))
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["mesh"]["losses"],
                                                   runs["unsharded"]["losses"]))
    print(json.dumps({"cards": world, "card": card, "batch": args.batch,
                      "loss_rel": rel, "loss_rel_bar": LOSS_REL,
                      "peak_gb_unsharded": runs["unsharded"]["peak_bytes"] / 1e9,
                      "peak_gb_mesh_max": max(
                          runs["mesh"]["peak_bytes_by_rank"]) / 1e9}))
    return 0 if rel <= LOSS_REL else 1


if __name__ == "__main__":
    sys.exit(main())
