"""Atomic, async checkpointing (port of ``repro/ckpt/checkpoint.py``).

Layout: <root>/step_<n>/ with one ``leaf_NNNNN.npy`` per leaf of a tree of
nested dicts, lists and tuples of tensors (dicts in sorted key order, as
JAX flattens them) and a ``manifest.json`` describing the tree.  Writes go
to a ``.tmp`` dir that is renamed into place: a crashed writer never leaves
a readable-but-partial checkpoint, and ``.tmp`` or manifest-less
directories are invisible.  Only the last ``keep`` checkpoints are kept.

Async: ``CheckpointManager.save`` takes a host copy of every leaf
synchronously (so the caller may update its tensors in place right after)
and writes it on a background thread.  NumPy has no bfloat16, so a bf16
leaf is stored as float32; ``restore`` casts each leaf to the dtype and
device of the template ``like``.

``restore(..., shardings=...)`` loads each leaf on the host and
``distribute_tensor``s it to its placements, which is also the
elastic-rescale path: a checkpoint saved on one topology restores onto any
mesh.  ``shardings`` mirrors ``like``: a leaf is a
``parallel.sharding.NamedSharding`` (a spec on a DeviceMesh) or None, the
default placement (the template's device), and a None in place of a whole
subtree stands for all its leaves.  A DTensor leaf is saved whole
(``full_tensor``, a collective every rank enters); under
``torch.distributed`` only rank 0 writes.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def _flatten(tree):
    """(leaves, structure); structure is a JSON-able description."""
    if isinstance(tree, dict):
        leaves, spec = [], {}
        for key in sorted(tree):
            sub, spec[key] = _flatten(tree[key])
            leaves += sub
        return leaves, {"dict": spec}
    if isinstance(tree, (list, tuple)):
        leaves, spec = [], []
        for item in tree:
            sub, s = _flatten(item)
            leaves += sub
            spec.append(s)
        return leaves, {"tuple" if isinstance(tree, tuple) else "list": spec}
    return [tree], None


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        if "dict" in s:
            return {k: build(v) for k, v in s["dict"].items()}
        if "tuple" in s:
            return tuple(build(v) for v in s["tuple"])
        return [build(v) for v in s["list"]]
    return build(spec)


def _leaf_names(n):
    return [f"leaf_{i:05d}" for i in range(n)]


def _shardings(spec, shardings) -> list:
    """The leaves of ``shardings`` in the order of ``spec``'s leaves (see
    ``_flatten``); a None subtree gives a None for each of its leaves."""
    if spec is None:
        return [shardings]
    if shardings is None:
        return [None] * _n_leaves(spec)
    if "dict" in spec:
        return [s for k, sub in spec["dict"].items()
                for s in _shardings(sub, shardings[k])]
    subs = spec.get("tuple", spec.get("list"))
    if len(subs) != len(shardings):
        raise ValueError(f"shardings has {len(shardings)} entries where the "
                         f"tree has {len(subs)}")
    return [s for sub, sh in zip(subs, shardings) for s in _shardings(sub, sh)]


def _n_leaves(spec) -> int:
    if spec is None:
        return 1
    subs = spec["dict"].values() if "dict" in spec else \
        spec.get("tuple", spec.get("list"))
    return sum(_n_leaves(sub) for sub in subs)


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(a) -> np.ndarray:
    """A numpy copy that later in-place updates of ``a`` do not reach."""
    if isinstance(a, DTensor):
        a = a.full_tensor()
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", copy=True)
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.array(a)


def save_pytree(path: str, tree: Any) -> None:
    leaves, spec = _flatten(tree)
    host = [_to_host(leaf) for leaf in leaves]  # every rank: DTensors gather
    if not _writer():
        return
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for name, arr in zip(_leaf_names(len(host)), host):
        np.save(os.path.join(tmp, name + ".npy"), arr)
    manifest = {"treedef": spec, "n_leaves": len(leaves),
                "shapes": [list(a.shape) for a in host],
                "dtypes": [str(leaf.dtype).replace("torch.", "")
                           for leaf in leaves]}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)  # atomic publish


def restore_pytree(path: str, like: Any, shardings: Any = None) -> Any:
    """The tree saved at ``path``, each leaf a tensor with the dtype of the
    matching leaf of ``like``, distributed by its entry in ``shardings``
    or, where that is None, on the leaf's device."""
    leaves, spec = _flatten(like)
    out = []
    for name, ref, sh in zip(_leaf_names(len(leaves)), leaves,
                             _shardings(spec, shardings)):
        arr = np.load(os.path.join(path, name + ".npy"))
        t = torch.from_numpy(np.array(arr))  # a writable copy
        if isinstance(ref, torch.Tensor):
            t = t.to(dtype=ref.dtype)
        if sh is not None:
            t = distribute_tensor(t.to(sh.mesh.device_type), sh.mesh,
                                  sh.placements())
        elif isinstance(ref, torch.Tensor):
            t = t.to(device=ref.device)
        out.append(t)
    return _unflatten(spec, out)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, async_save: bool = True):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, d, "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree: Any) -> None:
        # snapshot to host synchronously (every rank: a DTensor leaf is
        # gathered), write asynchronously (rank 0)
        leaves, spec = _flatten(tree)
        host = _unflatten(spec, [_to_host(leaf) for leaf in leaves])
        self.wait()
        if not _writer():
            return

        def _do():
            save_pytree(self._step_dir(step), host)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        return restore_pytree(self._step_dir(step), like, shardings)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
