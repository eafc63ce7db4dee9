"""Flash attention kernels (counterpart of ``repro/kernels/flash/flash.py``).

``flash_mha`` launches the hand-written CUDA kernel of ``csrc/flash_sm90.cu``
(wgmma + TMA) on CUDA tensors and runs its plain version ``attention_ref``
on CPU tensors; on any other device it raises.  ``route`` names the kernel's
path from the dtype alone, at every head dim of ``HEAD_DIMS``: bf16 takes
bf16 products (``"wgmma"``), fp32 three TF32 products of hi + lo parts
(``"wgmma_tf32x3"``).  There is no fallback to another kernel or to the
plain version: a build or launch error is raised.  ``flash_mha.launches``
counts kernel launches and ``flash_mha.launches_by_route`` splits them by
route.

The kernels read q, k and v through their strides (the last axis
contiguous), so a ``(B, S, H, hd)`` activation transposed to ``(B, H, S, hd)``
is passed as a view, and the output takes q's memory layout.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _launch as K
from repro_torch.kernels.build import load_library

from .ref import attention_ref

__all__ = ["HEAD_DIMS", "ROUTES", "flash_mha", "route"]

HEAD_DIMS = (32, 64, 128, 256)  # head dims the kernel is instantiated for, in each dtype
ROUTES = ("wgmma", "wgmma_tf32x3")


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel's path for a CUDA call with this dtype (at any hd in HEAD_DIMS)."""
    return "wgmma" if dtype == torch.bfloat16 else "wgmma_tf32x3"


@functools.cache
def _fn():
    """The C entry point; it dispatches on the dtype code and hd itself."""
    fn = load_library("flash_sm90").flash_sm90_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 12
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    )
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, H, S, hd) and k/v (B, KVH, S, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, hd = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != hd or k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} (H must be a multiple of KVH)")
    if q.dtype not in K.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """q (B, H, S, hd); k/v (B, KVH, S, hd); H % KVH == 0 → (B, H, S, hd) in q's dtype.

    Causal and/or sliding-window (key > query − window) masking; fp32
    running max, denominator and accumulator.
    """
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"q lies on {q.device}; flash_mha takes cuda or cpu tensors")
    b, h, s, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    out = torch.empty_like(q)  # keeps q's layout when q is a dense view
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if not K.aligned16(t):
            raise ValueError(f"{name}: the kernel needs hd contiguous and 16-byte aligned rows, "
                             f"got strides {t.stride()}")
    if b * h * s == 0:
        return out
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    name = route(q.dtype, hd)
    with torch.cuda.device(q.device):
        err = _fn()(
            K.DTYPE_CODES[q.dtype], hd, K.ptr(q), K.ptr(k), K.ptr(v), K.ptr(out),
            b, h, k.shape[1], s, *strides, int(causal), int(window), 1.0 / (hd**0.5), K.stream_of(q),
        )
    K.raise_on_error(err, f"flash_mha ({name})")
    flash_mha.launches += 1
    flash_mha.launches_by_route[name] += 1
    return out


flash_mha.launches = 0
flash_mha.launches_by_route = dict.fromkeys(ROUTES, 0)
