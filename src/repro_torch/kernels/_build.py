"""Build the CUDA sources under ``kernels/csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<hash>.so`` at the repo
root (``build/`` is git-ignored), compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface.  The hash covers the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source is rebuilt
and an unchanged one is reused.  All sources compile at once, one ``nvcc``
each.  Nothing is built at import: the first wrapper call (or ``build_all``)
builds.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List

import torch

from repro_torch import env

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
logs: Dict[str, str] = {}  # ptxas report (registers, shared memory, spills)


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no up-to-date library, in parallel,
    and load all of them.  Returns {source stem: library}."""
    with _lock:
        todo = [s for s in sources() if s.stem not in _libs]
        pending = [(s, _target(s)) for s in todo if not _target(s).exists()]
        if pending:
            nvcc = env.nvcc_path()
            if nvcc is None:
                raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin);"
                                   " the CUDA kernels cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = []
            for src, out in pending:
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                procs.append((src, out, tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for src, out, tmp, proc in procs:
                text, _ = proc.communicate()
                logs[src.stem] = text
                if proc.returncode != 0:
                    failed.append(f"{src.name} (nvcc rc {proc.returncode}):\n{text}")
                else:
                    os.replace(tmp, out)
            if failed:
                raise RuntimeError("CUDA build failed: " + "\n".join(failed))
        for src in todo:
            _libs[src.stem] = ctypes.CDLL(str(_target(src)))
        return dict(_libs)


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lies (or will)."""
    return _target(CSRC / f"{name}.cu")


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all()[name]


def bind(name: str, entry: str, argtypes) -> Callable[..., None]:
    """A launcher for the C entry point ``entry`` of ``csrc/<name>.cu``: it
    passes its arguments as ``argtypes`` and raises RuntimeError when the
    entry returns a nonzero cudaError (a refused launch never runs, and no
    later synchronize reports it).  Each source exports
    ``<name>_error_string``."""
    lib = library(name)
    fn = getattr(lib, entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    err_str = getattr(lib, f"{name}_error_string")
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p

    def launch(*args) -> None:
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: "
                               f"{err_str(rc).decode()} (cudaError {rc})")
    return launch


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """The kernels compute the forward only: their output, written through
    ctypes, carries no ``grad_fn``.  Raise rather than hand back a result
    whose gradient would silently be lost."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward yet, and an input "
            "requires grad; run it under torch.no_grad() or "
            "torch.inference_mode(), or on the CPU")
