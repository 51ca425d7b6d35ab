"""Device-fused ensemble execution on one card (the port of
``repro/core/ensemble.py``).

A leaf task's [lo, hi) sample range runs as ONE batched simulator call:
``simulator(batch, draws)`` over the whole (n, d) batch, with the rows'
random draws made on the device from their seeds by the simulator's
``draws_fn(seeds, device)`` (``sim/rng.py``).  The hierarchy still
generates the index space; only the leaf execution is fused.

Bucketing policy
----------------
``run_bundle`` pads every batch up to the next power-of-two *bucket*
(``bucket_for``) by repeating the last row, gives the pad rows the seeds
``hi … lo+padded-1`` (their outputs are sliced away), runs the bucket's
program and slices the outputs back to [lo, hi).  The number of programs
any workload builds is O(log2 max_bundle), not O(#distinct sizes).

One CUDA graph a bucket
-----------------------
On the card each bucket's program is captured once as a CUDA graph: static
input buffers for the batch and the seeds, the draws and the simulator
captured together, static output buffers.  A call copies its rows and
seeds into the inputs, replays the graph and clones the real rows of the
outputs on the same stream, all under one process-wide lock, so that the
next replay of that bucket (from any thread) cannot overwrite outputs that
a deferred bundle write has yet to copy to the host.  On the CPU the
batched function runs directly.  A capture or a replay that fails raises:
nothing falls back to eager execution.

Compile-cache policy
--------------------
Programs are cached **process-wide** by default, in a WeakKeyDictionary
on the simulator callable (a dead simulator's graphs go with it), keyed
by (device, input width, bucket).  ``share_cache=False`` gives
an executor its own cache.  ``trace_count()`` counts the programs built
in this process: graph captures on the card, first calls per bucket on
the CPU.

``step_fn()`` returns a Merlin fn-step that simulates ``ctx.sample_block``
and writes it through the Bundler; coalesced contexts (``ctx.sub_ranges``)
run as one launch and still write one bundle file per original sub-task.
Under the engine's write pipeline the host copy and the bundle writes run
later on its writer thread (``defer_write``).

Multi-device dispatch
---------------------
The reference ``shard_map``s a bucket over a 1-D mesh of the process's
local devices.  The executor is one process, so its mesh here is a tuple
of devices: :func:`device_mesh` gives the local CUDA devices (None on a
host with one).  A bucket whose size divides the device count splits into
contiguous blocks of n/ndev rows, block j on device j with seeds
``lo + j*n/ndev ...``: one program (one CUDA graph) a device and bucket,
launched on each device in turn (the replays run concurrently), the
outputs concatenated in row order.  Rows are independent and a row's
draws depend on its seed alone, so the split gives the single-device
result bit for bit where the simulator's arithmetic is exact per element.
A bucket that does not divide runs on one device.  ``stats["devices"]``
and ``stats["mesh_launches"]`` count as the reference's do.  A tuple of
repeated devices (``("cpu",) * 4``) splits the same way, which is how the
CPU tests hold the split to one device.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import env
from repro_torch.core.bundler import Bundler

# process-wide program cache + build counter ---------------------------------
_CACHE_LOCK = threading.Lock()
_SHARED: "weakref.WeakKeyDictionary[Callable, Dict[Tuple, _Program]]" = \
    weakref.WeakKeyDictionary()
_TRACE_COUNT = 0
# serializes every capture (the executors' buckets and the surrogate's Adam
# step, core/active.py), and every (copy in, replay, copy out) of an
# executor's graph, across the threads of this process
_GRAPH_LOCK = threading.RLock()


def device_mesh(axis: str = "data") -> Optional[Tuple[torch.device, ...]]:
    """The local CUDA devices of this process, as the executor's mesh;
    None on a host with at most one.  ``axis`` names the reference's mesh
    axis; a tuple of devices has one axis."""
    n = torch.cuda.device_count()
    if n <= 1:
        return None
    return tuple(torch.device("cuda", i) for i in range(n))


def _count_trace() -> None:
    global _TRACE_COUNT
    _TRACE_COUNT += 1


def trace_count() -> int:
    """Programs built in this process so far: CUDA-graph captures on the
    card, first calls of a bucket on the CPU."""
    return _TRACE_COUNT


def bucket_for(n: int) -> int:
    """Smallest power-of-two >= n: the padded batch size for a ragged n."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def bucket_schedule(max_n: int) -> List[int]:
    """All bucket sizes needed for bundles up to ``max_n`` (the compile
    bound asserted by the regression test: len == ceil(log2 max_n) + 1)."""
    out = [1]
    while out[-1] < max_n:
        out.append(out[-1] * 2)
    return out


def pad_rows(arr: np.ndarray, to: int) -> np.ndarray:
    """Pad a (n, ...) array to ``to`` rows by repeating the last row (keeps
    padded work numerically tame; outputs for pad rows are discarded)."""
    n = len(arr)
    if n == to:
        return arr
    reps = np.repeat(arr[-1:], to - n, axis=0)
    return np.concatenate([arr, reps], axis=0)


class _Program:
    """One bucket's batched simulator on one device: a captured CUDA graph
    on the card, the plain call on the CPU.  It keeps no reference to the
    simulator (the cache's weak key): callers pass it in."""

    def __init__(self, simulator: Callable, draws_fn: Optional[Callable],
                 n: int, d: int, device: torch.device):
        self.draws_fn = draws_fn
        self.n, self.device = n, device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        if device.type != "cuda":
            return
        # the program's device is current for the capture, and the capture
        # stream is its own: torch.cuda.graph's default capture stream
        # lives on whichever device first captured, and work on another
        # device's stream is never recorded (the graph comes out empty)
        with torch.cuda.device(device):
            self.x = torch.zeros(n, d, device=device)
            self.seeds = torch.arange(n, device=device, dtype=torch.int64)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self._call(simulator, self.x, self.seeds)  # warm-up
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"):
                self.out = self._call(simulator, self.x, self.seeds)

    def _call(self, simulator: Callable, x: torch.Tensor,
              seeds: torch.Tensor):
        draws = self.draws_fn(seeds, x.device) if self.draws_fn else {}
        return simulator(x, draws)

    def __call__(self, simulator: Callable, batch: np.ndarray, lo: int,
                 n_real: int) -> Dict[str, torch.Tensor]:
        """Outputs for rows [0, n_real) of the padded batch whose row i has
        seed lo + i; on the card, fresh tensors the next replay leaves
        alone."""
        if self.graph is None:
            x = torch.from_numpy(batch)
            seeds = torch.arange(lo, lo + self.n, dtype=torch.int64)
            out = self._call(simulator, x, seeds)
            return {k: v[:n_real] for k, v in out.items()}
        with _GRAPH_LOCK, torch.cuda.device(self.device):
            self.x.copy_(torch.from_numpy(batch))
            torch.arange(lo, lo + self.n, out=self.seeds)
            self.graph.replay()
            return {k: v[:n_real].clone() for k, v in self.out.items()}


def _host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in out.items()}


class EnsembleExecutor:
    def __init__(self, simulator: Callable, bundler: Optional[Bundler] = None,
                 mesh="auto", data_axis: str = "data", bucketed: bool = True,
                 share_cache: bool = True, device=None):
        """simulator: f(batch: (n, d) tensor, draws: dict) -> dict of (n, ...)
        tensors; its ``draws_fn(seeds, device)`` attribute, where it has one,
        makes the rows' draws (else the draws are empty).

        ``device``: ``cuda`` unless ``cpu`` is asked for (raises without a
        card).  ``mesh="auto"`` (default) resolves to :func:`device_mesh`
        on the card (None on one card, and on the CPU); ``mesh=None`` runs
        on ``device``; an explicit tuple of devices splits every bucket
        that divides its length over them.
        """
        self.simulator = simulator
        self.draws_fn = getattr(simulator, "draws_fn", None)
        self.bundler = bundler
        self.data_axis = data_axis
        self.device = env.device(device)
        if mesh == "auto":
            mesh = device_mesh(data_axis) if self.device.type == "cuda" \
                else None
        if mesh is not None and not isinstance(mesh, (tuple, list)):
            raise TypeError(f"mesh={mesh!r}: the executor takes 'auto', "
                            "None or a tuple of devices")
        self.mesh = None if mesh is None else tuple(torch.device(d)
                                                    for d in mesh)
        self.bucketed = bucketed
        self.share_cache = share_cache
        self._private: Dict[Tuple, _Program] = {}
        # worker threads, the engine and its writer share one executor
        self._stats_lock = threading.Lock()
        self.stats = {"bundles": 0, "samples": 0, "sim_time": 0.0,
                      "write_s": 0.0,
                      "compiles": 0, "launches": 0, "padded_samples": 0,
                      "mesh_launches": 0,
                      "devices": 1 if self.mesh is None else len(self.mesh)}

    def _mesh_divides(self, n: int) -> bool:
        """True when size-n batches split evenly over the mesh.  Power-of-
        two buckets >= a power-of-two device count always do, so the
        bucket padding doubles as the sharding grid; smaller buckets (or
        odd meshes) fall back to single-device dispatch."""
        return self.mesh is not None and n % len(self.mesh) == 0

    def _compiled(self, n: int, d: int, device=None) -> _Program:
        """The bucket-n program on ``device`` (default: the executor's)
        (cached; shared process-wide unless this executor opted out).
        Built under the graph lock: a capture sees no other thread's
        replay."""
        device = device or self.device
        key = (device, d, n)
        if self.share_cache:
            with _CACHE_LOCK:
                cache = _SHARED.setdefault(self.simulator, {})
        else:
            cache = self._private
        prog = cache.get(key)
        if prog is None:
            with _GRAPH_LOCK:
                prog = cache.get(key)
                if prog is None:
                    prog = _Program(self.simulator, self.draws_fn, n, d,
                                    device)
                    cache[key] = prog
                    _count_trace()
                    self._count(compiles=1)
        return prog

    def program(self, n: int, d: int) -> _Program:
        """The program a bundle of n rows of width d runs (for timing)."""
        return self._compiled(bucket_for(n) if self.bucketed else n, d)

    def run_bundle(self, lo: int, hi: int, samples: np.ndarray,
                   sub_ranges: Optional[Sequence[Tuple[int, int]]] = None,
                   block: bool = True, defer_write: bool = False):
        """Simulate samples [lo, hi) as one fused device launch.

        ``sub_ranges``: optional absolute [slo, shi) spans partitioning
        [lo, hi); one bundle file is written per span (coalesced execution
        keeps the per-task on-disk layout).  ``block=False`` skips the host
        copy and returns device tensors (only valid without a bundler).

        ``defer_write=True`` (bundler only) launches the compute and
        returns a zero-arg closure that copies the outputs to the host and
        writes the bundles when called — the engine's writer thread runs
        it, so the write of this bundle overlaps the launch of the next
        (``stats["write_s"]`` accumulates on the closure's thread).
        """
        t0 = time.monotonic()
        n = hi - lo
        samples = np.asarray(samples)
        if len(samples) != n:
            raise ValueError(f"sample block has {len(samples)} rows "
                             f"for range [{lo}, {hi})")
        padded = bucket_for(n) if self.bucketed else n
        # a writable float32 copy: torch takes no read-only numpy array
        batch = np.array(pad_rows(samples, padded), np.float32, order="C")
        if self._mesh_divides(padded):
            out = self._split(batch, lo, n)
        else:
            out = self._compiled(padded, batch.shape[1])(
                self.simulator, batch, lo, n)
        self._count(bundles=1, samples=n, padded_samples=padded - n,
                    launches=1, mesh_launches=int(self._mesh_divides(padded)))
        if self.bundler is not None:
            spans = tuple(sub_ranges or ((lo, hi),))

            def finish_write(dev_out=out):
                tw = time.monotonic()
                host = _host(dev_out)  # waits for this bundle's replay
                for slo, shi in spans:
                    sl = slice(slo - lo, shi - lo)
                    self.bundler.write_bundle(
                        slo, shi, {k: v[sl] for k, v in host.items()})
                self._count(write_s=time.monotonic() - tw)
                return host
            if defer_write:
                self._count(sim_time=time.monotonic() - t0)
                return finish_write
            out = finish_write()
        elif block:
            out = _host(out)
        self._count(sim_time=time.monotonic() - t0)
        return out

    def _split(self, batch: np.ndarray, lo: int, n: int
               ) -> Dict[str, torch.Tensor]:
        """The padded ``batch`` in contiguous blocks, block j on mesh
        device j with seeds from ``lo + j * block``; the real rows of the
        outputs in row order, on the first device."""
        blk = len(batch) // len(self.mesh)
        parts = []
        for j, dev in enumerate(self.mesh):
            prog = self._compiled(blk, batch.shape[1], dev)
            n_real = min(blk, max(0, n - j * blk))
            parts.append(prog(self.simulator, batch[j * blk:(j + 1) * blk],
                              lo + j * blk, n_real))
        return {k: torch.cat([p[k].to(self.mesh[0]) for p in parts])
                for k in parts[0]}

    def _count(self, **deltas) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self.stats[k] += v

    def step_fn(self) -> Callable:
        """A Merlin fn-step: simulate ctx's sample block and bundle results.

        Under deferred execution (the engine's write pipeline) the bundle
        write is parked on ``ctx.defer`` so it runs on the writer thread,
        after this batch's compute but overlapping the next launch."""
        def step(ctx):
            block = ctx.sample_block
            if block is None:
                raise ValueError("ensemble step requires study samples")
            pending = self.run_bundle(
                ctx.lo, ctx.hi, block,
                sub_ranges=getattr(ctx, "sub_ranges", None),
                defer_write=getattr(ctx, "deferrable", False))
            if callable(pending):
                ctx.defer(pending)
        return step
