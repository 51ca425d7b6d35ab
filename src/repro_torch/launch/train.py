"""Training launcher (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch jag-surrogate --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --arch jag-surrogate \\
      --steps 200 --data <bundler root>
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced --steps 4

Runs on the card unless ``--device cpu``; on the card attention's forward
and backward are the flash kernels.  Layer kinds whose kernels have no
backward yet (rwkv6's WKV6 scan, mamba2's SSD scan) raise there; on the CPU
they train through the plain versions.  Archs that read extras (whisper's
``enc_embed``, llama-vision's ``img_embed``) raise ``NotImplementedError``
on any device: their training is ROADMAP Queue A, "Training the encoder
archs".  Checkpoint/restart is automatic:
re-running with the same ``--workdir`` resumes.  ``--data`` takes a
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

from repro_torch import env

# layer kind -> the kernel it runs on the card, which has no backward yet
_NO_BACKWARD = {"rwkv6": "wkv6_scan", "mamba2": "ssd_scan"}
SCALAR_KEYS = ["yield", "tion", "velocity", "bang_time"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jag-surrogate")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default="synthetic",
                    help="synthetic | path to a bundler root of JAG results")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticTokens, ensemble_token_stream
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import ssd_scan as ssdk
    from repro_torch.kernels import wkv6_scan as wkvk
    from repro_torch.train.trainer import Trainer

    dev = env.device(args.device)
    cfg = (registry.reduced_config(args.arch) if args.reduced
           else registry.get_config(args.arch))
    if cfg.n_enc_layers or cfg.n_img_tokens:
        raise NotImplementedError(
            f"{cfg.arch_id} reads enc_embed / img_embed, which this launcher "
            "does not feed yet: ROADMAP Queue A, 'Training the encoder archs'")
    if dev.type == "cuda":
        for spec in cfg.plan:
            if spec.kind in _NO_BACKWARD:
                raise _build.no_backward(_NO_BACKWARD[spec.kind])
    if args.data == "synthetic":
        data = iter(SyntheticTokens(args.batch, args.seq, cfg.vocab_size))
        seq = args.seq
    else:
        from repro_torch.core.bundler import Bundler
        archive = Bundler(args.data).load_all()
        data = ensemble_token_stream(archive, SCALAR_KEYS, batch=args.batch,
                                     vocab=cfg.vocab_size)
        # a record is its inputs and scalars, one token each; the LM sees
        # all but the last as tokens and all but the first as labels
        seq = archive["inputs"].reshape(len(archive["inputs"]), -1).shape[1] \
            + len(SCALAR_KEYS) - 1

    tr = Trainer(cfg, args.workdir, data, lr=args.lr,
                 ckpt_every=args.ckpt_every, device=dev)
    before = {"flash": fak.launches, "flash_bwd": fak.bwd_launches,
              "wkv6": wkvk.launches, "ssd": ssdk.launches}
    t0 = time.time()
    state = tr.train(args.steps)
    dt = time.time() - t0
    done = len(tr.history)
    launched = {"flash": fak.launches, "flash_bwd": fak.bwd_launches,
                "wkv6": wkvk.launches, "ssd": ssdk.launches}
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
