"""Data pipelines.

* :class:`SyntheticTokens` — deterministic, step-indexed token stream
  (splitmix-style integer hashing: batch for step k is a pure function of
  (seed, k, host_shard), so a restarted/rescaled job replays identical data
  — the data-side requirement of checkpoint-restart fault tolerance).

* :func:`ensemble_token_stream` — the ML-readiness step of the paper: turn
  the bundler's simulation archives into LM training batches by quantizing
  each record's (inputs, scalars) into vocab bins — the "tokenized
  simulation record" format used to train the jag-surrogate.

* :func:`regression_dataset` — (features, targets) arrays for the
  surrogate-regression path used by the optimization-loop example.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class SyntheticTokens:
    def __init__(self, batch: int, seq: int, vocab: int, seed: int = 0,
                 n_hosts: int = 1, host_id: int = 0, extras: Optional[Dict] = None):
        self.batch, self.seq, self.vocab = batch, seq, vocab
        self.seed, self.n_hosts, self.host_id = seed, n_hosts, host_id
        self.extras = extras or {}
        self._step = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        n = self.batch * (self.seq + 1)
        mix = (step * 0x9E3779B97F4A7C15 + self.seed * 0xBF58476D1CE4E5B9
               + self.host_id) % (1 << 64)
        base = np.arange(n, dtype=np.uint64) + np.uint64(mix)
        z = base
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
        toks = (z % np.uint64(self.vocab)).astype(np.int32)
        toks = toks.reshape(self.batch, self.seq + 1)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for k, (shape, dtype) in self.extras.items():
            rng = np.random.default_rng(step * 1000 + self.seed)
            out[k] = (rng.standard_normal((self.batch,) + tuple(shape[1:]))
                      * 0.02).astype(dtype)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self._step)
        self._step += 1
        return b


def quantize_records(inputs: np.ndarray, scalars: np.ndarray, vocab: int,
                     bins_per_field: int = 256) -> np.ndarray:
    """Batched record quantization: (n, ...) inputs + (n, k) scalars ->
    (n, nf) token matrix in one vectorized op (no per-record Python loop).

    Each record's fields are binned into ``bins_per_field`` levels with
    per-field offsets so fields occupy disjoint vocab ranges."""
    inputs = np.asarray(inputs)
    scalars = np.asarray(scalars)
    n = len(inputs)
    fields = np.concatenate([inputs.reshape(n, -1), scalars.reshape(n, -1)],
                            axis=1)
    nf = fields.shape[1]
    assert nf * bins_per_field <= vocab, (nf, bins_per_field, vocab)
    q = np.clip((fields * bins_per_field).astype(np.int64), 0,
                bins_per_field - 1)
    return (q + np.arange(nf) * bins_per_field).astype(np.int32)


def quantize_record(inputs: np.ndarray, scalars: np.ndarray, vocab: int,
                    bins_per_field: int = 256) -> np.ndarray:
    """One simulation record -> token sequence: [field0_bin, field1_bin, ...]
    (single-record view of :func:`quantize_records`)."""
    return quantize_records(np.asarray(inputs)[None], np.asarray(scalars)[None],
                            vocab, bins_per_field)[0]


def tokenize_archive(data: Dict[str, np.ndarray], scalar_keys: Sequence[str],
                     vocab: int, bins_per_field: int = 256) -> np.ndarray:
    """Tokenize a whole loaded archive once: normalization and quantization
    each run exactly one vectorized pass over the stacked fields (the seed
    called ``quantize_record`` n times and re-derived normalization state on
    every stream construction)."""
    scal = np.stack([_normalize(data[k]) for k in scalar_keys], axis=1)
    return quantize_records(data["inputs"], scal, vocab, bins_per_field)


def ensemble_token_stream(data: Dict[str, np.ndarray], scalar_keys: Sequence[str],
                          batch: int, vocab: int, seed: int = 0
                          ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite stream of LM batches built from a loaded ensemble archive.

    The archive is tokenized once up front (:func:`tokenize_archive`); each
    yielded batch is a pure gather from the precomputed token matrix."""
    records = tokenize_archive(data, scalar_keys, vocab)
    n = len(records)
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, n, size=batch)
        toks = records[idx]
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def regression_dataset(data: Dict[str, np.ndarray], target: str = "yield",
                       drop_failed: bool = True):
    X = np.asarray(data["inputs"], np.float32)
    y = np.asarray(data[target], np.float32)
    if drop_failed:
        ok = np.isfinite(y)
        if "failed" in data:
            ok &= data["failed"] < 0.5
        X, y = X[ok], y[ok]
    return X, _normalize(y)


def _normalize(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    lo, hi = np.nanmin(x), np.nanmax(x)
    if hi - lo < 1e-12:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)
