"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package (``repro``) is the reference; this package imports nothing
of it, nor JAX.  Module paths mirror the reference's.  Entry points run on
``cuda`` unless the caller asks for the CPU.
"""
from repro_torch import env as _env

_env.pin_precision()
