"""The benchmark's cells shrunk to a size the CPU runs in seconds: the
same files and code, the configuration's widths and depth and the
traffic's rows and lengths cut (still over two of the reference's
64-step SSD chunks, so that the scans carry a state between chunks; the
shared attention's window no shorter than a training row, as at full
size, where the port's training attention does not window), and the
program computing in float32 so that sound runs agree with the reference
to round-off.

Besides the manifest's cells, the tests run the staged ones: cells whose
files are in the harness and whose manifest entries (``staged.json``:
``configs``, ``workloads`` and ``per_layer`` entries to add, and the
metrics whose ``workloads`` list them) wait for a change that makes them
steady enough to bound."""
from __future__ import annotations

import copy
import json
from dataclasses import replace
from pathlib import Path

from portbench.lib import manifest

STAGED = Path(__file__).with_name("staged.json")

WIDTHS = {
    "zamba2": dict(d_model=64, vocab_size=512, n_heads=4, n_kv_heads=4,
                   head_dim=16, d_ff=128, ssm_state=16, ssm_head_dim=16,
                   window=192, n_repeat=1),
    "rwkv6": dict(d_model=64, vocab_size=512, head_dim=16, d_ff=128,
                  lora_decay=8, n_repeat=2),
    # routing groups of 64 tokens, three a row
    "deepseek": dict(d_model=64, vocab_size=512, n_heads=4, kv_lora_rank=16,
                     qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, d_ff=128,
                     n_experts=8, top_k=2, d_ff_expert=32, moe_group=64,
                     n_repeat=2),
}
TRAFFIC = {
    "train": dict(rows=4, seq_len=192, warm_steps=2, trace_steps=1),
    "decode": dict(rows=4, prompt_len=160, prefill_rows=2, max_new_tokens=64,
                   warm_steps=2, trace_steps=2, checked_rows=2),
}


def with_staged(root=manifest.ROOT) -> dict:
    """The manifest at ``root`` with the staged cells' entries added."""
    man = manifest.load(root)
    with open(STAGED) as f:
        staged = json.load(f)
    for group in ("configs", "workloads", "per_layer"):
        man[group] += staged[group]
    cells = [w["name"] for w in staged["workloads"]]
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in staged["listed_in"]:
            m["workloads"] = m["workloads"] + cells
    return man


def full(name: str, root=manifest.ROOT) -> manifest.Cell:
    """A cell of the manifest or a staged one, at its own size."""
    return manifest.cell(name, root, with_staged(root))


def cell(name: str, compute: str = "float32",
         root=manifest.ROOT) -> manifest.Cell:
    c = full(name, root)
    config, traffic = copy.deepcopy(c.config), dict(c.traffic)
    m = config["model"]
    over = dict(config["port"]["overrides"])
    fields = config["port"]["fields"]
    for k, v in WIDTHS[m["family"]].items():
        m[k] = v
        if k in fields:
            over[fields[k]] = v
    over.update(n_repeat=m["n_repeat"],
                n_layers=len(m.get("prologue", [])) + len(m["superblock"]) * m["n_repeat"],
                compute_dtype=compute, microbatch=1)
    if m["family"] == "rwkv6":
        over["ssm_chunk"] = 8
    config["port"]["overrides"] = over
    config["precision"] = dict(config["precision"], compute=compute,
                               cache=compute)
    traffic.update(TRAFFIC[traffic["kind"]])
    return replace(c, config=config, traffic=traffic)
