"""Argument checks and launch plumbing shared by the mixing kernels' wrappers."""
from __future__ import annotations

import ctypes

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_w(w: torch.Tensor) -> None:
    if w.ndim != 2:
        raise ValueError(f"W must be (n, d), got shape {tuple(w.shape)}")
    if w.dtype not in DTYPE_CODES:
        raise TypeError(f"W must be float32 or bfloat16, got {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("W must be contiguous")
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"W lies on {w.device}; the mixing kernels take cuda or cpu tensors")


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device} but W lies on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def vec_width(w: torch.Tensor, y: torch.Tensor) -> int:
    """Widest of 4/2/1 elements per thread that divides d and keeps every
    row of W and Y aligned for one vector load/store."""
    d, size = w.shape[1], w.element_size()
    for vec in (4, 2, 1):
        align = vec * size
        if d % vec == 0 and w.data_ptr() % align == 0 and y.data_ptr() % align == 0:
            return vec
    return 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
