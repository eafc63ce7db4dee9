"""RWKV-6 chunked time-mix kernels (counterpart of ``repro/kernels/rwkv/rwkv.py``).

``rwkv6_chunked`` launches the hand-written CUDA kernel of
``csrc/rwkv_sm90.cu`` (chunk-parallel state passing, tensor-core products on
split fp32 operands) on CUDA tensors and runs its plain version
``rwkv6_chunked_ref`` on CPU tensors; on any other device it raises.
``route`` names the kernel's path from the dtype of r, k, v alone, at every
head dim of ``HEAD_DIMS``: ``"tc"`` for bf16 (bf16 products, fp32
operands split into bf16 hi + lo), ``"tc_fp32"`` for fp32 (TF32 products
on hi + lo parts, v split too).  An L of at most
SPAN (128, one span) runs in one launch, the span's outputs alone, with no
scratch; a longer L in three (span deltas, the state scan, span outputs).  There is no fallback to another kernel or
to the plain version: a build or launch error is raised.
``rwkv6_chunked.launches`` counts kernel launches,
``rwkv6_chunked.launches_by_route`` splits them by route and
``rwkv6_chunked.one_launch`` counts those that ran in one launch.  The
kernel has no backward: a CUDA call that autograd would record raises
(``kernels._launch.no_backward``).

It differs from the JAX package's Pallas kernel in what it carries out: it
takes an initial state and returns the final one (the decode cache a
prefill fills), and its output is fp32, as the model's ``_wkv_chunked``
returns (the Pallas kernel returns r's dtype).  r, k and v may be fp32 or
bf16; w, u and the states are fp32 (bf16 would round the slowest decays,
~1 - 2^-9, to 1 or 1 - 2^-8).  The kernels read r, k, v and w through
their (b, l, h) strides with M contiguous and each row 16-byte aligned, so
the model's projections go in as views, and u is indexed by head, not tiled
over the batch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _launch as K
from repro_torch.kernels.build import load_library

from .ref import SPAN, rwkv6_chunked_ref

__all__ = ["HEAD_DIMS", "ROUTES", "check_layout", "route", "rwkv6_chunked", "scratch_floats", "span_scratch_floats"]

HEAD_DIMS = (32, 64, 128)  # head dims the kernel is instantiated for, in each dtype
ROUTES = ("tc", "tc_fp32")


def route(dtype: torch.dtype, m: int) -> str:
    """The kernel's path for a CUDA call with r/k/v of this dtype (at any M in HEAD_DIMS)."""
    return "tc" if dtype == torch.bfloat16 else "tc_fp32"


def scratch_floats(b: int, l: int, h: int, m: int) -> int:
    """fp32 scratch a call needs: none for one span (L ≤ SPAN, one launch);
    else a state (M × M) and a decay row per span of SPAN tokens."""
    return 0 if l <= SPAN else span_scratch_floats(b, l, h, m)


def span_scratch_floats(b: int, l: int, h: int, m: int) -> int:
    """fp32 scratch of the three launches: a state (M × M) and a decay row
    per span of SPAN tokens (given for one span, it runs three launches)."""
    return b * h * -(-l // SPAN) * m * (m + 1)


@functools.cache
def _fn():
    """The C entry point; it dispatches on the dtype code and M itself."""
    fn = load_library("rwkv_sm90").rwkv6_sm90_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 15
        + [ctypes.c_void_p]
    )
    return fn


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


def check_layout(r, k, v, w) -> None:
    """Raise on a head dim or a memory layout the kernel does not take: M in
    HEAD_DIMS, contiguous, and every (b, l, h) row starting on a 16-byte
    boundary (its cp.async copies)."""
    m = r.shape[-1]
    if m not in HEAD_DIMS:
        raise ValueError(f"head_dim {m} not in {HEAD_DIMS}")
    for label, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(3) != 1:
            raise ValueError(f"{label}: the kernel needs M contiguous, got strides {t.stride()}")
        if not K.aligned16(t):
            raise ValueError(f"{label}: the kernel needs 16-byte aligned (b, l, h) rows, got strides "
                             f"{t.stride()} at offset {t.data_ptr() % 16} mod 16")


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
    K.no_backward("rwkv6_chunked", r, k, v, w, u, state)
    b, l, h, m = r.shape
    name = route(r.dtype, m)
    got = _launch(r, k, v, w, u, state, scratch_floats(b, l, h, m))
    rwkv6_chunked.launches += 1
    rwkv6_chunked.launches_by_route[name] += 1
    rwkv6_chunked.one_launch += int(0 < l <= SPAN)
    return got


def _launch(r, k, v, w, u, state, n_scratch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One call of the kernel on checked CUDA tensors, with ``n_scratch``
    floats of scratch: none runs one span (L ≤ SPAN) in one launch;
    ``span_scratch_floats`` runs the three launches.  Counts nothing."""
    b, l, h, m = r.shape
    check_layout(r, k, v, w)
    u = u.contiguous()
    if state is not None:
        state = state.contiguous()
        if state.data_ptr() % 16:
            state = state.clone()
    out = torch.empty(b, l, h, m, dtype=torch.float32, device=r.device)
    state_out = torch.empty(b, h, m, m, dtype=torch.float32, device=r.device)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=r.device)
    strides = [st for t in (r, k, v, w, out) for st in t.stride()[:3]]
    null = ctypes.c_void_p(None)
    with torch.cuda.device(r.device):
        err = _fn()(
            K.DTYPE_CODES[r.dtype], m, K.ptr(r), K.ptr(k), K.ptr(v), K.ptr(w), K.ptr(u),
            null if state is None else K.ptr(state), K.ptr(out), K.ptr(state_out),
            K.ptr(scratch) if n_scratch else null, b, l, h, *strides, K.stream_of(r),
        )
    K.raise_on_error(err, f"rwkv6_chunked ({route(r.dtype, m)})")
    return out, state_out


rwkv6_chunked.launches = 0
rwkv6_chunked.launches_by_route = dict.fromkeys(ROUTES, 0)
rwkv6_chunked.one_launch = 0
