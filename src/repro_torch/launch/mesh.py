"""Mesh construction (port of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
process group.  Both build a ``torch.distributed`` ``DeviceMesh`` with the
reference's axis names over the ranks of the process group that already
exists: the real ranks (``make_host_mesh``), or the production meshes'
256 / 512 ranks, which only the dry run (``launch/dryrun.py``) supplies as a
"fake" group on one process.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _mesh(shape, axes, device_type):
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} ranks needs a process group "
                           "(the dry run makes a fake one)")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"need {n} ranks, the process group has {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    """16x16 = 256 chips a pod; 2 pods when ``multi_pod``.  Uses the first
    prod(shape) ranks, so a 512-rank group builds both meshes."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_host_mesh(data: int = 1, model: int = 1, device_type=None):
    """A ``(data, model)`` mesh over the first data x model real ranks, on
    the card when one is visible."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return _mesh((data, model), ("data", "model"), device_type)
