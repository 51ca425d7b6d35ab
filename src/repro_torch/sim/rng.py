"""Counter-based random draws in plain torch integer ops.

The reference draws each row's numbers from ``jax.random.PRNGKey(seed)``
(threefry).  The port draws them from a hash of (row seed, stream, element
index) instead, so that

* a row's numbers depend on its seed alone, whatever bucket or batch the
  row runs in;
* the CPU and the card give the same bits (integer arithmetic only; the
  floats made from them differ at most in the last place of ``log``,
  ``sqrt`` and ``cos``);
* the whole draw is a handful of elementwise kernels that a CUDA graph
  captures with the simulator.

The hash is two rounds of MurmurHash3's 32-bit finalizer.  Values live in
int64 tensors holding 32-bit words; each 32x32-bit product is split into
16-bit halves so that no intermediate leaves int64's range.  The numbers
are not threefry's: parity tests hand both sides the same draws instead.
"""
from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for words a in [0, 2**32) and a constant c."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _fmix32_int(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def bits(seeds: torch.Tensor, stream: int, count: int) -> torch.Tensor:
    """(n, count) 32-bit words in int64: word j of row i hashes
    (seeds[i], stream, j)."""
    salt = _fmix32_int((stream * 0x9E3779B9 + 0x7F4A7C15) & _M32)
    key = _fmix32(_mul32(seeds.to(torch.int64) & _M32, 0x9E3779B9) ^ salt)
    ctr = torch.arange(count, device=seeds.device, dtype=torch.int64)
    x = _fmix32((_mul32(ctr, 0xCC9E2D51)[None, :] + key[:, None]) & _M32)
    return _fmix32(x ^ key[:, None])


def _unit(words: torch.Tensor) -> torch.Tensor:
    """Words -> float32 in (0, 1): the top 24 bits plus half a step, exact."""
    return ((words >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def uniform(seeds: torch.Tensor, stream: int, count: int) -> torch.Tensor:
    """(n, count) float32 uniforms in (0, 1)."""
    return _unit(bits(seeds, stream, count))


def normal(seeds: torch.Tensor, stream: int, count: int) -> torch.Tensor:
    """(n, count) float32 standard normals (Box-Muller, both branches)."""
    half = (count + 1) // 2
    w = bits(seeds, stream, 2 * half)
    radius = torch.sqrt(-2.0 * torch.log(_unit(w[:, :half])))
    theta = (2.0 * math.pi) * _unit(w[:, half:])
    z = torch.cat([radius * torch.cos(theta), radius * torch.sin(theta)], 1)
    return z[:, :count]
