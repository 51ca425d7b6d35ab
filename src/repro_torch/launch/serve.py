"""LM serving entry point of the port (``llm_serve_main``, after
``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch {jag-surrogate,rwkv6-3b,zamba2-1.2b} --full

serves random-weight requests on the card and prints one JSON object of
throughput and of the launches of each kernel in the run.  ``--device cpu`` runs on the CPU through the plain versions of
the kernels.  The Merlin CLIs of the reference come with later slices.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch import env
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import ssd_scan as ssdk
from repro_torch.kernels import wkv6_scan as wkvk
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine


def llm_serve_main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="granite-3-8b",
                    choices=sorted(registry.ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    dev = env.device(args.device)
    cfg = (registry.reduced_config(args.arch) if args.reduced
           else registry.get_config(args.arch))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.new_tokens + 8)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    kernels = {"flash_launches": fak, "wkv6_launches": wkvk,
               "ssd_launches": ssdk}
    launches0 = {name: mod.launches for name, mod in kernels.items()}
    out = eng.generate(toks, args.new_tokens)
    s = eng.stats
    print(json.dumps({
        "arch": cfg.arch_id, "batch": args.batch,
        "prefill_tok_per_s": round(s["prefill_tokens"] / max(s["prefill_s"], 1e-9)),
        "decode_tok_per_s": round(s["decode_tokens"] / max(s["decode_s"], 1e-9)),
        "generated_shape": list(out.shape),
        "device": env.device_name(dev),
        **{name: mod.launches - launches0[name]
           for name, mod in kernels.items()},
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(llm_serve_main())
