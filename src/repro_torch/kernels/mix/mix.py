"""Dense DecAvg mixing kernel  Y = M · W  (counterpart of ``repro/kernels/mix/mix.py``).

``mix_matmul`` launches the hand-written CUDA kernel of ``csrc/mix.cu`` on a
CUDA tensor and runs its plain version ``decavg_mix_ref`` on a CPU tensor;
on any other device it raises.  There is no fallback from the kernel to the
plain version.  ``mix_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load_library

from . import _launch as L
from .ref import decavg_mix_ref

__all__ = ["mix_matmul"]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("mix")
    lib.mix_dense.restype = ctypes.c_int
    lib.mix_dense.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def mix_matmul(m: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Y = M @ W with M (n, n) fp32 mixing weights and W (n, d) fp32 or bf16
    node-major params; fp32 accumulation, Y in W's dtype."""
    L.check_w(w)
    n, d = w.shape
    L.check_operand(m, "M", torch.float32, (n, n), w.device)
    if w.device.type == "cpu":
        return decavg_mix_ref(m, w)
    y = torch.empty_like(w)
    if n == 0 or d == 0:
        return y
    with torch.cuda.device(w.device):
        err = _lib().mix_dense(
            L.DTYPE_CODES[w.dtype], L.ptr(m), L.ptr(w), L.ptr(y), n, d,
            L.vec_width(w, y), L.stream_of(w),
        )
    L.raise_on_error(err, "mix_matmul")
    mix_matmul.launches += 1
    return y


mix_matmul.launches = 0
