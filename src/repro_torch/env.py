"""Device selection, float32 precision pins and an environment snapshot.

Precision: a float32 matrix product stays in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default) and a
float32 convolution does too (``torch.backends.cudnn.allow_tf32 = False``;
PyTorch's default there is TF32).  Both are set when ``repro_torch`` is
imported, so a float32 run on the card computes what the reference computes.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Any, Dict, Optional

import torch


def pin_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def device(name: Optional[str] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``cpu`` is asked
    for.  Raises when CUDA is wanted and no card is visible."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def nvcc_path() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def _run_line(cmd) -> Optional[str]:
    """First line of a command's output that says something, or None."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return lines[0] if lines else None


def nvidia_smi_line() -> Optional[str]:
    """``name, power.limit`` of the first card, as nvidia-smi prints them."""
    return _run_line(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"])


def snapshot() -> Dict[str, Any]:
    """What a measurement must carry: versions, card and power limit."""
    nvcc = nvcc_path()
    nvcc_line = None
    if nvcc:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60)
        rel = [ln for ln in out.stdout.splitlines() if "release" in ln]
        nvcc_line = rel[0].strip() if rel else None
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc_line,
        "device": torch.cuda.get_device_name(0) if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "nvidia_smi": nvidia_smi_line() if cuda else None,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }
