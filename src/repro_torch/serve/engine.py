"""Batched serving engine (port of ``repro/serve/engine.py``): prefill, then
greedy autoregressive decode over the cache stack of models/lm.py, through
the step functions ``make_prefill_fn`` / ``make_decode_fn``.

Models with cross-attention take their extras (``enc_embed`` for whisper's
encoder, ``img_embed`` for llama-vision's image tokens) at prefill, in the
order of ``extra_shapes``; decode reads the cached cross-attention K/V.

Under a ``mesh`` (a ``DeviceMesh`` with named dims, every rank running the
same calls) the functions run under ``activation_rules(mesh, rules)``:
the parameters come placed (``sharding.shard_module``), the tokens and
extras are split over the batch axes, the caches are placed as the
reference's dry run places them (``sharding.cache_spec``), the products run
tensor-parallel over ``model`` and the logits come back as a DTensor.  The
engine gathers them whole to pick the next tokens.

Eager: each step runs as PyTorch issues it.  Times end in a device
synchronize on the card, so ``stats`` holds device-complete wall time.
"""
from __future__ import annotations

import time

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.parallel import sharding as shd


def extra_shapes(cfg: ModelConfig, batch: int):
    """The extras a model reads at prefill, key -> shape, in the order
    ``prefill_fn`` takes them (empty for a model that reads none)."""
    shapes = {}
    if cfg.n_enc_layers:
        shapes["enc_embed"] = (batch, cfg.enc_len, cfg.d_model)
    if cfg.n_img_tokens:
        shapes["img_embed"] = (batch, cfg.n_img_tokens, cfg.d_vision)
    return shapes


def _extra_keys(cfg: ModelConfig):
    return list(extra_shapes(cfg, 1))


def _split_batch(x, mesh):
    """A batch input split over the active rules' batch axes (a DTensor
    passes as it is)."""
    if mesh is None or isinstance(x, DTensor):
        return x
    ctx = shd.current()
    spec = shd.spec_for(x.shape, ("batch",) + (None,) * (x.dim() - 1), mesh,
                        ctx.rules)
    return distribute_tensor(x, mesh, shd.placements(spec, mesh))


def _call(params, mesh, fn, *args):
    """``fn(params, *args)``; under a mesh with the parameters outside the
    layers read in compute placements (each layer gathers its own)."""
    if mesh is None:
        return fn(params, *args)
    return shd.call_with(params, lm.gathered_top(params), fn, *args)


def make_prefill_fn(cfg: ModelConfig, max_len: int, mesh=None, rules=None,
                    cache_dtype=torch.bfloat16):
    """``prefill_fn(params, tokens, *extra) -> (logits, caches)``."""
    def prefill_fn(params, tokens, *extra_kv):
        with shd.activation_rules(mesh, rules):
            tokens = _split_batch(tokens, mesh)
            extra = {k: _split_batch(v, mesh)
                     for k, v in zip(_extra_keys(cfg), extra_kv)}
            return _call(params, mesh, lambda p, t: lm.prefill(
                p, t, cfg, max_len=max_len, extra=extra,
                cache_dtype=cache_dtype), tokens)
    return prefill_fn


def make_decode_fn(cfg: ModelConfig, mesh=None, rules=None):
    """``decode_fn(params, token, caches) -> (logits, caches)``; a step
    is the span ``decode_step`` (``spans.step``)."""
    def decode_fn(params, token, caches):
        with spans.step("decode_step", "decode"), \
                shd.activation_rules(mesh, rules):
            token = _split_batch(token, mesh)
            return _call(params, mesh, lambda p, t: lm.decode_step(
                p, t, caches, cfg), token)
    return decode_fn


def _whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


class ServeEngine:
    """Greedy batched generation with throughput accounting."""

    def __init__(self, cfg: ModelConfig, params: lm.LM, max_len: int = 512,
                 cache_dtype=torch.bfloat16, mesh=None, rules=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.device = params.embed.device
        self.prefill_fn = make_prefill_fn(cfg, max_len, mesh, rules,
                                          cache_dtype)
        self.decode_fn = make_decode_fn(cfg, mesh, rules)
        self.stats = {"prefill_tokens": 0, "decode_tokens": 0,
                      "prefill_s": 0.0, "decode_s": 0.0}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, tokens, n_new: int, extra=None):
        extra = extra or {}
        tokens = tokens.to(self.device)
        t0 = time.monotonic()
        extra_vals = [extra[k].to(self.device) for k in _extra_keys(self.cfg)]
        logits, caches = self.prefill_fn(self.params, tokens, *extra_vals)
        self._sync()
        self.stats["prefill_s"] += time.monotonic() - t0
        self.stats["prefill_tokens"] += tokens.numel()
        out = [torch.argmax(_whole(logits)[:, -1], dim=-1)]
        t0 = time.monotonic()
        for _ in range(n_new - 1):
            logits, caches = self.decode_fn(self.params, out[-1][:, None], caches)
            out.append(torch.argmax(_whole(logits), dim=-1))
        self._sync()
        self.stats["decode_s"] += time.monotonic() - t0
        self.stats["decode_tokens"] += (n_new - 1) * tokens.shape[0]
        return torch.stack(out, dim=1)
