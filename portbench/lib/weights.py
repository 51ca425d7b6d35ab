"""Weights and tokens from the seed, on the device.

Parameters are drawn a group at a time (``embed``, ``final_norm``,
``layers.<i>``, ``shared_attn``): one standard-normal draw z of the
group's size from a generator on the device seeded by (seed, group), then
each leaf is made from its slice by the first rule of the configuration's
``init`` that matches its name, ``[pattern, kind, a, b]`` or
``[pattern, kind, a, b, then]``:

  normal       a z + b
  fan_in       a z / sqrt(rows) + b: x @ W keeps x's size (rows: the
               second axis from the end, the input axis of a stack of
               matrices such as a MoE layer's experts)
  uniform      uniform on [a, b] (z through the normal CDF)
  log_uniform  exp of uniform on [log a, log b]
  ramp         a to b along the last axis, evenly (z unused)

and ``then``, where given, maps the result: ``log``, or
``softplus_inverse`` (the bias whose softplus is the value).  The same
seed gives the same values on every call, so the reference gets the
program's initial weights by drawing them again.
"""
from __future__ import annotations

import hashlib
import math
import re
from typing import Dict, Iterator, Tuple

import torch


def derive(seed: int, *labels) -> int:
    """A 63-bit generator seed from the run's seed and labels."""
    text = repr((int(seed),) + labels).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *labels) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *labels))


def group_of(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "layers" else parts[0]


def _leaf(z: torch.Tensor, name: str, rules) -> torch.Tensor:
    """The leaf ``name`` made in place from its standard-normal slice."""
    for pattern, kind, a, b, *then in rules:
        if re.search(pattern, name):
            break
    else:
        raise ValueError(f"no init rule matches {name!r}")
    if kind == "normal":
        z.mul_(a).add_(b)
    elif kind == "fan_in":
        z.mul_(a / math.sqrt(z.shape[-2] if z.dim() > 1 else z.shape[0])).add_(b)
    elif kind in ("uniform", "log_uniform"):
        u = z.div_(math.sqrt(2.0)).erf_().add_(1.0).mul_(0.5)
        if kind == "uniform":
            u.mul_(b - a).add_(a)
        else:
            u.mul_(math.log(b / a)).add_(math.log(a)).exp_()
    elif kind == "ramp":
        n = z.shape[-1]
        z.copy_(torch.linspace(a, b, n, device=z.device).expand_as(z))
    else:
        raise ValueError(f"init rule kind {kind!r}: normal | fan_in | "
                         "uniform | log_uniform | ramp")
    for t in then:
        if t == "log":
            z.log_()
        elif t == "softplus_inverse":  # x + log(1 - exp(-x))
            z.add_(torch.log(-torch.expm1(-z)))
        else:
            raise ValueError(f"init rule map {t!r}: log | softplus_inverse")
    return z


def groups(shapes: Dict[str, tuple]) -> Dict[str, Dict[str, tuple]]:
    out: Dict[str, Dict[str, tuple]] = {}
    for name, shape in shapes.items():
        out.setdefault(group_of(name), {})[name] = shape
    return out


@torch.no_grad()
def draw(shapes: Dict[str, tuple], rules, seed: int, device
         ) -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
    """(group, {name: float32 tensor}) for every group, in order."""
    for group, leaves in groups(shapes).items():
        total = sum(math.prod(s) for s in leaves.values())
        flat = torch.randn(total, generator=generator(device, seed, "w", group),
                           device=device)
        out, o = {}, 0
        for name, shape in leaves.items():
            n = math.prod(shape)
            out[name] = _leaf(flat[o:o + n].view(shape), name, rules)
            o += n
        yield group, out
        del flat, out


def draw_all(shapes, rules, seed, device, part=None) -> Dict[str, torch.Tensor]:
    """Every parameter, each a tensor of its own; ``part(name, tensor)``,
    where given, keeps only the part of a leaf it returns."""
    out = {}
    for _, leaves in draw(shapes, rules, seed, device):
        out.update({k: (v if part is None else part(k, v)).clone()
                    for k, v in leaves.items()})
    return out


def tokens(device, seed: int, label, rows: int, length: int, vocab: int):
    """(rows, length) token ids uniform over the vocabulary."""
    return torch.randint(0, vocab, (rows, length), device=device,
                         generator=generator(device, seed, "tokens", label))


def train_batch(device, seed: int, step: int, rows: int, seq_len: int,
                vocab: int) -> Dict[str, torch.Tensor]:
    """Step ``step``'s rows: ``seq_len + 1`` tokens each, the inputs and
    the next-token labels.  Rows differ within and across steps."""
    t = tokens(device, seed, ("train", step), rows, seq_len + 1, vocab)
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}
