"""Multi-pod dry run on meta tensors (port of ``repro/launch/dryrun.py``):
every (arch x shape) cell placed on the production mesh, run once on one
rank's shards, to show what a device holds and does there.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

The reference lowers and compiles each cell with XLA on 256 / 512 forced
host devices and reads XLA's analyses.  Here one process joins a "fake"
``torch.distributed`` group of 256 (``(16, 16)`` ``("data", "model")``) or
512 (``(2, 16, 16)`` with ``"pod"``) ranks as rank 0, builds the state,
inputs and caches on the meta device (shapes and dtypes, no data), places
them as DTensors by the port's specs (``sharding.param_spec_tree``,
``trainstep.opt_shardings``, ``sharding.cache_spec``, the batch split) and
runs the train step, the prefill fn or the decode fn once (``lower_cell``
builds and places; ``analyze`` runs and counts).  The port's layers are a
Python loop, so every layer is counted directly.

How each key maps (numbers are rank 0's, the largest shard where a split
is uneven):

* ``lower_s``: seconds to build and place the state, inputs and caches;
  ``compile_s``: seconds of the one meta run.
* ``flops``: ``LocalCounter`` over the rank's local operators (an op on a
  DTensor is seen as the local op DTensor runs, so a product split 16 ways
  counts 1/16 of the global FLOPs, a replicated one all of them), plus the
  kernels' work (``kernels/flops.py``: valid query-key pairs for flash
  attention, its backward as recompute + dP + dV + dQ + dK).
  ``bytes_accessed``: the bytes of every local operator's tensor inputs and
  outputs, summed.
* ``memory.argument_bytes``: the rank's local bytes of parameters,
  optimizer state and step (train), inputs, and caches with their int32
  position (decode).  ``output_bytes``: the local bytes of what the fn
  returns.  ``temp_bytes``: train, the peak bytes autograd holds saved
  for the backward (``saved_tensors_hooks``, local shards, each storage
  once, the arguments' own excluded); prefill / decode, the peak of the local
  tensors the run keeps alive at once.  ``peak_live_bytes``: that peak for
  every kind.  ``alias_bytes``: the donated state (train) or caches
  (decode).  ``generated_code_bytes``: 0, nothing is compiled.
* ``collectives``: for each kind, the bytes of the local operands of the
  collectives the run issues (an all-gather's input shard, an all-reduce's
  buffer), and ``count``, the collectives issued (the counter sees
  DTensor's functional collectives on the local shards; ``CommDebugMode``
  counts the same ones, but its module tracker fails under remat inside
  ``functional_call``).
* ``reconstructed``: the reference's two-probe decomposition (depth-1 and
  depth-2 probes, microbatch 1): ``base_flops`` = 2 p1 - p2 and
  ``layer_flops`` = p2 - p1, the same for bytes, and ``flops`` / bytes /
  collectives extrapolated to the full depth, kept for readers of the
  reference's output.
* ``n_params``, ``n_active_params``, ``model_flops``: ``model_flops_info``,
  as the reference's.

``_shape_bytes`` and ``collective_bytes`` are the reference's parsers of
XLA's HLO text, kept as pure helpers; no torch run produces HLO.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import registry
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.kernels import flops as kflops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.parallel import sharding as shd
from repro_torch.serve.engine import _extra_keys, make_decode_fn, make_prefill_fn
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.trainstep import (TrainState, make_train_step,
                                         named_params, shard_state)

CACHE_DTYPE = torch.bfloat16
META = torch.device("meta")


def fake_group(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0, unless a
    group exists already (which must be large enough)."""
    if dist.is_initialized():
        if dist.get_world_size() < world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks exists; the mesh needs {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


# ---------------------------------------------------------------------------
# sharding trees
# ---------------------------------------------------------------------------

def _rules(arch: str, mesh) -> Dict:
    r = dict(shd.DEFAULT_RULES)
    over = registry.arch_rules(arch)
    if over:
        r.update(over)
    shape = shd.mesh_shape(mesh)
    return {k: tuple(a for a in v if a in shape) for k, v in r.items()}


def batch_shardings(cfg: ModelConfig, specs: Dict[str, torch.Tensor], mesh,
                    rules) -> Dict[str, shd.NamedSharding]:
    out = {}
    for k, v in specs.items():
        logical = ("batch",) + (None,) * (v.dim() - 1)
        out[k] = shd.NamedSharding(mesh, shd.spec_for(v.shape, logical, mesh,
                                                      rules))
    return out


def _local_bytes(t) -> int:
    t = t._local_tensor if isinstance(t, DTensor) else t
    return t.numel() * t.element_size()


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, torch.nn.Module):
        return sum(_local_bytes(p) for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        return _local_bytes(tree)
    return 0


def _spec_bytes(t: torch.Tensor, sh: shd.NamedSharding) -> int:
    """Local bytes of ``t`` placed by ``sh`` (rank 0's block)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(
        t.shape, sh.mesh, sh.placements())
    n = 1
    for d in local:
        n *= d
    return n * t.element_size()


def _storages(tree, out=None) -> set:
    """The storages of every local tensor in ``tree`` (arguments)."""
    out = set() if out is None else out
    if isinstance(tree, dict):
        for v in tree.values():
            _storages(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _storages(v, out)
    elif isinstance(tree, torch.nn.Module):
        _storages(list(tree.parameters()), out)
    elif isinstance(tree, torch.Tensor):
        t = tree._local_tensor if isinstance(tree, DTensor) else tree
        out.add(t.untyped_storage()._cdata)
    return out


# ---------------------------------------------------------------------------
# lowering per workload kind
# ---------------------------------------------------------------------------

class Cell:
    """A placed cell: ``run()`` runs it once; ``args`` its arguments;
    ``argument_bytes`` their local bytes; ``alias`` what it donates."""

    def __init__(self, kind, run, args, argument_bytes, alias):
        self.kind, self.run, self.args = kind, run, args
        self.argument_bytes, self.alias = argument_bytes, alias


def lower_cell(arch: str, shape_name, mesh,
               cfg: Optional[ModelConfig] = None) -> Cell:
    """The cell (``shape_name``: a name of ``SHAPES`` or a ShapeConfig)
    built on meta and placed on ``mesh``."""
    cfg = cfg or registry.get_config(arch)
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    rules = _rules(arch, mesh)
    over = registry.arch_rules(arch)
    specs = registry.input_specs(cfg, shape, abstract=True)
    b_sh = batch_shardings(cfg, specs, mesh, rules)
    in_bytes = sum(_spec_bytes(specs[k], b_sh[k]) for k in specs)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), META)

    if shape.kind == "train":
        opt = make_optimizer(cfg.optimizer, cfg=cfg)
        state = TrainState(params, opt.init(named_params(params)),
                           torch.zeros((), dtype=torch.int32, device=META))
        state = shard_state(state, mesh, over)
        step = make_train_step(cfg, opt, mesh=mesh, rules=over)
        state_bytes = _tree_bytes([state.params, state.opt, state.step])
        return Cell("train", lambda: step(state, specs), [state, specs],
                    state_bytes + in_bytes, state_bytes)
    shd.shard_module(params, mesh, over)
    p_bytes = _tree_bytes(params)
    if shape.kind == "prefill":
        fn = make_prefill_fn(cfg, max_len=shape.seq_len, mesh=mesh,
                             rules=over, cache_dtype=CACHE_DTYPE)
        args = [specs["tokens"]] + [specs[k] for k in _extra_keys(cfg)]
        return Cell("prefill", lambda: fn(params, *args), [params, specs],
                    p_bytes + in_bytes, 0)
    with shd.activation_rules(mesh, over):
        caches = lm.init_caches(cfg, shape.global_batch, shape.seq_len,
                                CACHE_DTYPE, META)
    # one new token against a full seq_len-deep cache
    caches["pos"] = shape.seq_len - 1
    c_bytes = _tree_bytes(caches["layers"]) + 4  # + the int32 position
    fn = make_decode_fn(cfg, mesh=mesh, rules=over)
    return Cell("decode", lambda: fn(params, specs["token"], caches),
                [params, specs, caches], p_bytes + in_bytes + c_bytes,
                c_bytes)


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLL_OPS = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all"}
# operators that allocate nothing and move no data
_FREE = {"view", "_unsafe_view", "empty_strided", "empty", "detach", "alias",
         "t", "transpose", "permute", "expand", "as_strided", "slice",
         "select", "unsqueeze", "squeeze", "split", "split_with_sizes",
         "_to_copy_noop", "wait_tensor", "_wrap_tensor_autograd", "unbind"}


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the stack: it builds
    global-shape stand-ins (and keeps them in its cache), which are no
    rank's memory or work."""
    f = sys._getframe(2)
    for _ in range(24):
        if f is None:
            return False
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class LocalCounter(TorchDispatchMode):
    """Counts what one rank does: every operator on plain tensors (an op
    on a DTensor is passed to DTensor, whose local operators then come
    back here; DTensor's propagation on fake tensors is skipped).  FLOPs
    by ``torch.utils.flop_counter``'s formulas plus the kernels' own
    (``kernels.flops``), bytes of each op's tensor operands, collective
    bytes by kind, and the peak bytes of the local tensors alive at once
    (each storage once while any tensor on it lives; the arguments'
    storages, ``exclude``, are not counted).
    The same counter on a real card's step counts the same numbers."""

    def __init__(self, exclude: set = frozenset()):
        super().__init__()
        self.exclude = exclude  # the arguments' storages: not live temps
        self.flops = 0.0
        self.kernel_flops: Dict[str, float] = {}
        self.bytes = 0
        self.coll = {k: 0 for k in COLLECTIVES}
        self.coll_count = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}

    def add_kernel_flops(self, name, n):
        self.flops += n
        self.kernel_flops[name] = self.kernel_flops.get(name, 0.0) + n

    def _hold(self, t):
        """Count ``t``'s storage live while any tensor on it lives (a view
        can outlive its base)."""
        key = t.untyped_storage()._cdata
        if key in self.exclude:
            return
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [0, t.untyped_storage().nbytes()]
            self.live += ref[1]
            self.peak = max(self.peak, self.live)
        ref[0] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key):
        ref = self._refs[key]
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if (any(issubclass(t, FakeTensor) for t in types)
                or _in_sharding_propagation()):
            return out  # DTensor's sharding propagation: no rank's work
        name = func._overloadpacket.__name__.rstrip("_")
        if func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        if name in _COLL_OPS:
            self.coll_count += 1
            self.coll[_COLL_OPS[name]] += sum(
                a.numel() * a.element_size() for a in args
                if isinstance(a, torch.Tensor))
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        outs = [o for o in (out if isinstance(out, (list, tuple)) else [out])
                if isinstance(o, torch.Tensor)]
        if name not in _FREE:
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        seen = {id(a) for a in ins}
        for o in outs:
            if id(o) not in seen:
                self._hold(o)
        return out


class SavedBytes(torch.autograd.graph.saved_tensors_hooks):
    """The peak bytes autograd holds saved for a backward at once: each
    local storage once while any tensor saved on it lives, the arguments'
    own storages excluded (a microbatch's saved tensors are freed by its
    backward before the next one's forward saves its own)."""

    def __init__(self, exclude: set):
        self.exclude = set(exclude)
        self.refs: Dict[int, list] = {}
        self.live = 0
        self.bytes = 0

        def release(key):
            ref = self.refs[key]
            ref[0] -= 1
            if ref[0] == 0:
                self.live -= ref[1]
                del self.refs[key]

        def pack(t):
            loc = t._local_tensor if isinstance(t, DTensor) else t
            key = loc.untyped_storage()._cdata
            if key in self.exclude:
                return t
            if key not in self.refs:
                self.refs[key] = [0, loc.untyped_storage().nbytes()]
                self.live += self.refs[key][1]
                self.bytes = max(self.bytes, self.live)
            self.refs[key][0] += 1
            weakref.finalize(loc, release, key)
            return t
        super().__init__(pack, lambda t: t)


def analyze(cell: Cell) -> Dict[str, Any]:
    info: Dict[str, Any] = {}
    args = _storages(cell.args)
    counter = LocalCounter(args)
    saved = SavedBytes(args)
    grad = torch.enable_grad() if cell.kind == "train" else torch.no_grad()
    t0 = time.time()
    with kflops.counting(counter), counter, grad:
        if cell.kind == "train":
            with saved:
                out = cell.run()
        else:
            out = cell.run()
    info["compile_s"] = round(time.time() - t0, 1)
    info["flops"] = float(counter.flops)
    info["kernel_flops"] = counter.kernel_flops
    info["bytes_accessed"] = float(counter.bytes)
    out_bytes = _tree_bytes(list(out))
    info["memory"] = {
        "argument_bytes": int(cell.argument_bytes),
        "output_bytes": int(out_bytes),
        "temp_bytes": int(saved.bytes if cell.kind == "train"
                          else counter.peak),
        "peak_live_bytes": int(counter.peak),
        "generated_code_bytes": 0,
        "alias_bytes": int(cell.alias),
    }
    info["collectives"] = dict(counter.coll)
    info["collectives"]["count"] = counter.coll_count
    return info


# ---------------------------------------------------------------------------
# the reference's HLO parsers (pure text helpers)
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(tok: str) -> int:
    m = _SHAPE_RE.match(tok)
    if not m:
        return 0
    dt, dims = m.group(1), m.group(2)
    if dt not in _DTYPE_BYTES:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dt]


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum operand bytes of every collective op in (partitioned) HLO text."""
    out = {k: 0 for k in COLLECTIVES}
    out["count"] = 0
    for line in hlo_text.splitlines():
        s = line.strip()
        for kind in COLLECTIVES:
            # match "= TYPE[dims] kind(" or "kind-start("
            m = re.search(rf"=\s+(\S+)\s+{kind}(?:-start)?\(([^)]*)\)", s)
            if m is None:
                continue
            operands = m.group(2)
            b = sum(_shape_bytes(t) for t in re.findall(r"\w+\[[\d,]*\]",
                                                        operands))
            if b == 0:  # operand list may omit shapes; use result shape
                b = _shape_bytes(m.group(1).split("(")[0])
                # tuple results: sum inner shapes
                if b == 0:
                    b = sum(_shape_bytes(t) for t in
                            re.findall(r"\w+\[[\d,]*\]", m.group(1)))
            out[kind] += b
            out["count"] += 1
            break
    return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _probe_cfg(cfg: ModelConfig, n_rep: int) -> ModelConfig:
    """Reduced-depth probe (the reference's): n_repeat superblocks,
    microbatch 1; enc-dec configs scale the encoder depth alongside."""
    over = {"n_repeat": n_rep, "microbatch": 1, "scan_unroll": True,
            "n_layers": len(cfg.prologue) + len(cfg.superblock) * n_rep}
    if cfg.n_enc_layers:
        over["n_enc_layers"] = n_rep
    return cfg.replace(**over)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             cfg: Optional[ModelConfig] = None,
             skip_probes: bool = False) -> Dict[str, Any]:
    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = cfg or registry.get_config(arch)
    t0 = time.time()
    cell = lower_cell(arch, shape_name, mesh, cfg=cfg)
    res = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(s) for s in mesh.shape),
           "chips": mesh.size(), "lower_s": round(time.time() - t0, 1)}
    res.update(analyze(cell))
    del cell

    if not skip_probes:
        p1 = analyze(lower_cell(arch, shape_name, mesh, cfg=_probe_cfg(cfg, 1)))
        p2 = analyze(lower_cell(arch, shape_name, mesh, cfg=_probe_cfg(cfg, 2)))
        reps = cfg.n_repeat
        rec: Dict[str, Any] = {}
        for key in ("flops", "bytes_accessed"):
            rec[key] = p1[key] + (p2[key] - p1[key]) * (reps - 1)
        rec["collectives"] = {
            k: int(p1["collectives"][k] + (p2["collectives"][k]
                                           - p1["collectives"][k]) * (reps - 1))
            for k in COLLECTIVES}
        rec["probe_compile_s"] = p1["compile_s"] + p2["compile_s"]
        rec["base_flops"] = 2 * p1["flops"] - p2["flops"]
        rec["layer_flops"] = p2["flops"] - p1["flops"]
        rec["base_bytes"] = 2 * p1["bytes_accessed"] - p2["bytes_accessed"]
        rec["layer_bytes"] = p2["bytes_accessed"] - p1["bytes_accessed"]
        res["reconstructed"] = rec
    res.update(model_flops_info(cfg, SHAPES[shape_name]))
    return res


def model_flops_info(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Analytic MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (inference),
    the 'useful compute' yardstick for the roofline table."""
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), META)
    total = 0
    expert = 0
    for name, p in params.named_parameters():
        n = p.numel()
        total += n
        if any("experts" in k for k in name.split(".")):
            expert += n
    n_active = total - expert
    if cfg.n_experts:
        n_active += expert * cfg.top_k / cfg.n_experts
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    return {"n_params": int(total), "n_active_params": int(n_active),
            "model_flops": float(mult * n_active * tokens)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--override", type=str, default=None,
                    help="JSON dict of ModelConfig overrides (perf iteration)")
    ap.add_argument("--cache-dtype", type=str, default=None,
                    help="decode cache dtype override (e.g. int8 KV)")
    args = ap.parse_args(argv)

    if args.cache_dtype:
        global CACHE_DTYPE
        CACHE_DTYPE = getattr(torch, args.cache_dtype)
    overrides = json.loads(args.override) if args.override else None

    cells = []
    if args.all:
        for arch in registry.ARCHS:
            if arch == "jag-surrogate":
                continue
            cfg = registry.get_config(arch)
            for s in SHAPES.values():
                if shape_applicable(arch, s.name, cfg.family):
                    cells.append((arch, s.name))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    results = []
    for arch, shape in cells:
        print(f"=== dry-run {arch} x {shape} "
              f"({'multi-pod 2x16x16' if args.multi_pod else 'single-pod 16x16'}) ===",
              flush=True)
        try:
            cfg = None
            if overrides:
                cfg = registry.get_config(arch).replace(**overrides)
            res = run_cell(arch, shape, args.multi_pod, cfg=cfg)
            if overrides:
                res["overrides"] = overrides
            res["ok"] = True
            print(json.dumps(res, indent=1), flush=True)
        except Exception as e:  # a cell's failure is reported, not hidden
            res = {"arch": arch, "shape": shape, "ok": False,
                   "error": f"{type(e).__name__}: {e}"[:2000]}
            print("FAILED:", res["error"], flush=True)
        results.append(res)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    nok = sum(r["ok"] for r in results)
    print(f"\n{nok}/{len(results)} cells passed")
    return 0 if nok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
