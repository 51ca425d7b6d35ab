"""Batched serving engine (port of ``repro/serve/engine.py``): prefill, then
greedy autoregressive decode over the cache stack of models/lm.py.

Eager: each step runs as PyTorch issues it.  Times end in a device
synchronize on the card, so ``stats`` holds device-complete wall time.
"""
from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


class ServeEngine:
    """Greedy batched generation with throughput accounting."""

    def __init__(self, cfg: ModelConfig, params: lm.LM, max_len: int = 512,
                 cache_dtype=torch.bfloat16):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.device = params.embed.device
        self.stats = {"prefill_tokens": 0, "decode_tokens": 0,
                      "prefill_s": 0.0, "decode_s": 0.0}

    def prefill_fn(self, params, tokens):
        return lm.prefill(params, tokens, self.cfg, max_len=self.max_len,
                          cache_dtype=self.cache_dtype)

    def decode_fn(self, params, token, caches):
        return lm.decode_step(params, token, caches, self.cfg)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, tokens, n_new: int):
        tokens = tokens.to(self.device)
        t0 = time.monotonic()
        logits, caches = self.prefill_fn(self.params, tokens)
        self._sync()
        self.stats["prefill_s"] += time.monotonic() - t0
        self.stats["prefill_tokens"] += tokens.numel()
        out = [torch.argmax(logits[:, -1], dim=-1)]
        t0 = time.monotonic()
        for _ in range(n_new - 1):
            logits, caches = self.decode_fn(self.params, out[-1][:, None], caches)
            out.append(torch.argmax(logits, dim=-1))
        self._sync()
        self.stats["decode_s"] += time.monotonic() - t0
        self.stats["decode_tokens"] += (n_new - 1) * tokens.shape[0]
        return torch.stack(out, dim=1)
