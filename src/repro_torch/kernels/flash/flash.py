"""Flash attention kernels (counterpart of ``repro/kernels/flash/flash.py``).

``flash_mha`` launches the hand-written CUDA kernel of ``csrc/flash_sm90.cu``
(wgmma + TMA) on CUDA tensors and runs its plain version ``attention_ref``
on CPU tensors; on any other device it raises.  ``route`` names the kernel's
path from the dtype alone, at every head dim of ``HEAD_DIMS``: bf16 takes
bf16 products (``"wgmma"``), fp32 three TF32 products of hi + lo parts
(``"wgmma_tf32x3"``).  There is no fallback to another kernel or to the
plain version: a build or launch error is raised.  ``flash_mha.launches``
counts kernel launches and ``flash_mha.launches_by_route`` splits them by
route; ``flash_mha.padded`` counts the launches that went through
zero-padded copies.  The kernel has no backward: a CUDA call that autograd would record
(grad enabled and q, k or v requiring grad) raises, rather than return an
output that no gradient flows through.

The kernels read q, k and v through their strides (the last axis
contiguous), so a ``(B, S, H, hd)`` activation transposed to ``(B, H, S, hd)``
is passed as a view, and the output takes q's memory layout.  hd 160
(stablelm-12b) has an instance of its own.  A head dim the kernel is not
instantiated for (hd 30, 40 ...), or rows that are not 16-byte aligned, go
through ``padded_head_dim``: q, k and v are copied
zero-padded up to the next size in ``HEAD_DIMS``, the kernel runs with the
true hd's softmax scale and the output is sliced back.  Zero columns add
nothing to q·k, and v's zero columns give zero outputs, which are cut.
Above 256 it raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _launch as K
from repro_torch.kernels.build import load_library

from .ref import attention_ref

__all__ = ["HEAD_DIMS", "ROUTES", "flash_mha", "padded_head_dim", "route"]

HEAD_DIMS = (32, 64, 128, 160, 256)  # head dims the kernel is instantiated for, in each dtype
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


def padded_head_dim(hd: int) -> int:
    """The instantiated head dim a call at ``hd`` runs at: the least of
    ``HEAD_DIMS`` at or above it."""
    for size in HEAD_DIMS:
        if hd <= size:
            return size
    raise ValueError(f"head_dim {hd} exceeds {HEAD_DIMS[-1]}, the largest the flash kernel is instantiated for")


def with_padded_head_dim(attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **mask) -> torch.Tensor:
    """``attend(q', k', v', scale=1/√hd, **mask)`` on copies of q, k and v
    zero-padded on the head axis to ``padded_head_dim(hd)``, the output
    sliced back to hd (a view of the padded result)."""
    hd = q.shape[-1]
    size = padded_head_dim(hd)

    def padded(t):
        out = torch.zeros(*t.shape[:-1], size, dtype=t.dtype, device=t.device)
        out[..., :hd] = t
        return out

    return attend(padded(q), padded(k), padded(v), scale=1.0 / (hd**0.5), **mask)[..., :hd]


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
    K.no_backward("flash_mha", q, k, v)
    if q.shape[-1] not in HEAD_DIMS or not all(K.aligned16(t) for t in (q, k, v)):
        out = with_padded_head_dim(_launch, q, k, v, causal=causal, window=window)
        flash_mha.padded += 1
        return out
    return _launch(q, k, v, scale=1.0 / (q.shape[-1] ** 0.5), causal=causal, window=window)


def _launch(q, k, v, *, scale: float, causal: bool, window: int) -> torch.Tensor:
    """One kernel launch: hd in ``HEAD_DIMS``, q, k, v rows 16-byte aligned."""
    b, h, s, hd = q.shape
    out = torch.empty_like(q)  # keeps q's layout when q is a dense view
    if b * h * s == 0:
        return out
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    name = route(q.dtype, hd)
    with torch.cuda.device(q.device):
        err = _fn()(
            K.DTYPE_CODES[q.dtype], hd, K.ptr(q), K.ptr(k), K.ptr(v), K.ptr(out),
            b, h, k.shape[1], s, *strides, int(causal), int(window), scale, K.stream_of(q),
        )
    K.raise_on_error(err, f"flash_mha ({name})")
    flash_mha.launches += 1
    flash_mha.launches_by_route[name] += 1
    return out


flash_mha.launches = 0
flash_mha.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_mha.padded = 0
