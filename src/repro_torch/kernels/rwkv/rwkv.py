"""RWKV-6 chunked time-mix kernel (counterpart of ``repro/kernels/rwkv/rwkv.py``).

``rwkv6_chunked`` launches the hand-written CUDA kernel of ``csrc/rwkv.cu``
(two launches: the parallel intra-chunk part, then the sequential state
scan) on CUDA tensors and runs its plain version ``rwkv6_chunked_ref`` on
CPU tensors; on any other device it raises.  There is no fallback from the
kernel to the plain version.  ``rwkv6_chunked.launches`` counts kernel
launches.

It differs from the JAX package's Pallas kernel in what it carries out: it
takes an initial state and returns the final one (the decode cache a
prefill fills), and its output is fp32, as the model's ``_wkv_chunked``
returns (the Pallas kernel returns r's dtype).  r, k and v may be fp32 or
bf16; w, u and the states are fp32 (bf16 would round the slowest decays,
~1 - 2^-9, to 1 or 1 - 2^-8).  The kernel reads r, k, v and w through
their (b, l, h) strides with M contiguous, so the model's projections go in
as views, and u is indexed by head, not tiled over the batch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _launch as K
from repro_torch.kernels.build import load_library

from .ref import CHUNK, rwkv6_chunked_ref

__all__ = ["HEAD_DIMS", "rwkv6_chunked"]

HEAD_DIMS = (32, 64, 128)  # head dims the kernel is instantiated for


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("rwkv")
    lib.rwkv6_fwd.restype = ctypes.c_int
    lib.rwkv6_fwd.argtypes = (
        [ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 11
        + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 15
        + [ctypes.c_void_p]
    )
    return lib


def _check(r, k, v, w, u, state) -> None:
    if r.ndim != 4 or k.shape != r.shape or v.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"want r, k, v, w (B, L, H, M) alike, got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    b, _, h, m = r.shape
    if u.shape != (h, m):
        raise ValueError(f"u {tuple(u.shape)} is not (H, M) = {(h, m)}")
    if state is not None and state.shape != (b, h, m, m):
        raise ValueError(f"state {tuple(state.shape)} is not (B, H, M, M) = {(b, h, m, m)}")
    if r.dtype not in K.DTYPE_CODES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must all be float32 or bfloat16, got {r.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("w", w), ("u", u), ("state", state)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    devices = {t.device for t in (r, k, v, w, u, state) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"r, k, v, w, u, state lie on {sorted(map(str, devices))}")


def rwkv6_chunked(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v (B, L, H, M) fp32 or bf16; w (B, L, H, M) fp32 in (0, 1]; u (H, M)
    fp32; state (B, H, M, M) fp32 or None (zero) → (out (B, L, H, M) fp32,
    the fp32 state after token L)."""
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return rwkv6_chunked_ref(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"r lies on {r.device}; rwkv6_chunked takes cuda or cpu tensors")
    b, l, h, m = r.shape
    if m not in HEAD_DIMS:
        raise ValueError(f"head_dim {m} not in {HEAD_DIMS}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the kernel needs M contiguous, got strides {t.stride()}")
    u = u.contiguous()
    if state is not None:
        state = state.contiguous()
    out = torch.empty(b, l, h, m, dtype=torch.float32, device=r.device)
    state_out = torch.empty(b, h, m, m, dtype=torch.float32, device=r.device)
    # per chunk of 32 tokens the state needs two fp32 factor rows per token
    # and one decay row, written by the intra-chunk kernel
    n_fac = b * h * -(-l // CHUNK) * CHUNK * m
    scratch = torch.empty(2 * n_fac + n_fac // CHUNK, dtype=torch.float32, device=r.device)
    strides = [st for t in (r, k, v, w, out) for st in t.stride()[:3]]
    s_in = ctypes.c_void_p(None) if state is None else K.ptr(state)
    with torch.cuda.device(r.device):
        err = _lib().rwkv6_fwd(
            K.DTYPE_CODES[r.dtype], m, K.ptr(r), K.ptr(k), K.ptr(v), K.ptr(w), K.ptr(u), s_in,
            K.ptr(out), K.ptr(state_out), K.ptr(scratch), K.ptr(scratch[n_fac:]), K.ptr(scratch[2 * n_fac:]),
            b, l, h, *strides, K.stream_of(r),
        )
    K.raise_on_error(err, "rwkv6_chunked")
    rwkv6_chunked.launches += 1
    return out, state_out


rwkv6_chunked.launches = 0
