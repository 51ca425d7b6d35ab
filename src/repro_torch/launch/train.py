"""Training launcher (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch jag-surrogate --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --arch jag-surrogate \\
      --steps 200 --data <bundler root>
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
      --repeats 16 --steps 20 --data <bundler root>

Runs on the card unless ``--device cpu``; on the card attention's forward
and backward are the flash kernels, rwkv6's and mamba2's scans the WKV6 and
SSD kernels and their backward kernels; on the CPU every layer trains
through the plain versions under autograd.  Archs that read extras get them
in every batch, random bfloat16 as the reference's synthetic stream draws
them: whisper's ``enc_embed`` (batch, enc_len, d_model) and
llama-vision's ``img_embed`` (batch, n_img_tokens, d_vision).  The
reference feeds them on the synthetic stream only (its ``--data`` batches
lack them, and whisper's loss then raises); the port feeds them on both,
so whisper trains on a study's bundles too, where the loss can fall
(uniform synthetic tokens carry nothing to learn).  ``--repeats K`` cuts
the depth to the prologue and K repeats of the superblock, at full width
(a model whose float32 weights and AdamW moments do not fit a card whole).  Checkpoint/restart is
automatic: re-running with the same ``--workdir`` resumes.  ``--data`` takes a
bundler root of JAG results, tokenized as the reference does; the default
is the synthetic token stream.  Prints one JSON summary: the reference's
keys plus ``device`` and the kernel launch counts of the run.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from repro_torch import env
from repro_torch.data.pipeline import SyntheticTokens

SCALAR_KEYS = ["yield", "tion", "velocity", "bang_time"]


def with_extras(stream, extras):
    """The batches of ``stream`` with the model's extras (``extras``: name
    -> (shape, dtype), as the reference's launcher names them) added as
    bfloat16 tensors.  Step k's extras are the ones the reference's
    ``SyntheticTokens(..., extras=)`` draws at step k; the draw is float32
    (numpy has no bfloat16 without ``ml_dtypes``, which the port does not
    need) and the cast rounds it as the reference's ``astype`` does."""
    if not extras:
        yield from stream
        return
    batch = next(iter(extras.values()))[0][0]
    draws = SyntheticTokens(batch, 1, 2, extras={
        k: (shape, "float32") for k, (shape, _) in extras.items()})
    for step, b in enumerate(stream):
        drawn = draws.batch_at(step)
        yield {**b, **{k: torch.from_numpy(drawn[k]).to(torch.bfloat16)
                       for k in extras}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jag-surrogate")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--repeats", type=int, default=None,
                    help="superblock repeats (default: the config's)")
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (0: none, not even at "
                         "the end)")
    ap.add_argument("--data", default="synthetic",
                    help="synthetic | path to a bundler root of JAG results")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import ensemble_token_stream
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import ssd_scan as ssdk
    from repro_torch.kernels import wkv6_scan as wkvk
    from repro_torch.train.trainer import Trainer

    dev = env.device(args.device)
    cfg = (registry.reduced_config(args.arch) if args.reduced
           else registry.get_config(args.arch))
    if args.repeats is not None:
        cfg = cfg.replace(n_repeat=args.repeats, n_layers=len(cfg.prologue)
                          + args.repeats * len(cfg.superblock))
    extras = {}
    if cfg.n_enc_layers:
        extras["enc_embed"] = ((args.batch, cfg.enc_len, cfg.d_model),
                               "bfloat16")
    if cfg.n_img_tokens:
        extras["img_embed"] = ((args.batch, cfg.n_img_tokens, cfg.d_vision),
                               "bfloat16")
    if args.data == "synthetic":
        data = with_extras(SyntheticTokens(args.batch, args.seq,
                                           cfg.vocab_size), extras)
        seq = args.seq
    else:
        from repro_torch.core.bundler import Bundler
        archive = Bundler(args.data).load_all()
        data = with_extras(ensemble_token_stream(
            archive, SCALAR_KEYS, batch=args.batch, vocab=cfg.vocab_size),
            extras)
        # a record is its inputs and scalars, one token each; the LM sees
        # all but the last as tokens and all but the first as labels
        seq = archive["inputs"].reshape(len(archive["inputs"]), -1).shape[1] \
            + len(SCALAR_KEYS) - 1

    tr = Trainer(cfg, args.workdir, data, lr=args.lr,
                 ckpt_every=args.ckpt_every, device=dev)
    before = {"flash": fak.launches, "flash_bwd": fak.bwd_launches,
              "wkv6": wkvk.launches, "wkv6_bwd": wkvk.bwd_launches,
              "ssd": ssdk.launches, "ssd_bwd": ssdk.bwd_launches}
    t0 = time.time()
    state = tr.train(args.steps)
    dt = time.time() - t0
    done = len(tr.history)
    launched = {"flash": fak.launches, "flash_bwd": fak.bwd_launches,
                "wkv6": wkvk.launches, "wkv6_bwd": wkvk.bwd_launches,
                "ssd": ssdk.launches, "ssd_bwd": ssdk.bwd_launches}
    summary = {
        "arch": cfg.arch_id, "steps": int(state.step),
        "ran_steps": done, "final_loss": tr.history[-1]["loss"] if done else None,
        "first_loss": tr.history[0]["loss"] if done else None,
        "wall_s": round(dt, 1), "stragglers": tr.stragglers,
        "tokens_per_s": round(done * args.batch * seq / max(dt, 1e-9)),
        "device": env.device_name(dev),
        **{f"{k}_launches": launched[k] - before[k] for k in launched},
    }
    print(json.dumps(summary, indent=1))
    return summary, tr


if __name__ == "__main__":
    main()
