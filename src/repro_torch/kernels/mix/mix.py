"""Dense DecAvg mixing kernel  Y = M · W  (counterpart of ``repro/kernels/mix/mix.py``).

``mix_matmul`` launches the hand-written CUDA kernel of ``csrc/mix.cu`` on a
CUDA tensor and runs its plain version ``decavg_mix_ref`` on a CPU tensor;
on any other device it raises.  There is no fallback from the kernel to the
plain version.  ``dense_route`` names the kernel's route from (n, d, dtype)
alone: ``"thin"`` (a warp an output row, lanes over k, for the gossip
payloads' few columns) or ``"wide"`` (a block a strip of columns and group
of rows, for the training widths).  No pointer enters the choice, so a
chunked or resumed run sums in the same order as an uninterrupted one.
``mix_matmul.launches`` counts kernel launches and
``mix_matmul.launches_by_route`` splits them by route.

M may be a row block, (r, n) with r ≤ n: a rank's rows of the round
operator against the all-gathered payload in the node-sharded round
(``core/shardplan.py``).  The route is still picked from (n, d, dtype), and
the square call is the unsharded plan's, bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _launch as K
from repro_torch.kernels.build import load_library

from . import _launch as L
from .ref import decavg_mix_ref

__all__ = ["D_THIN", "ROUTES", "dense_route", "mix_matmul"]

ROUTES = ("thin", "wide")  # in the order of the C entry's route codes
D_THIN = 16  # widest W the thin route takes
WIDE_MAX_N = 3584  # the wide route stages 16 rows of M a block: 16·n fp32 in at most 224 KB of shared memory
_THIN_TILES = (1, 2, 4, 8, 16, 32)  # columns a warp of the thin route sums: the kernel's instances


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("mix")
    lib.mix_dense.restype = ctypes.c_int
    lib.mix_dense.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    return lib


def dense_route(n: int, d: int, dtype: torch.dtype) -> str:
    """The kernel's route for an (n, n) M and an (n, d) W of this dtype."""
    return "thin" if d <= D_THIN or n > WIDE_MAX_N else "wide"


def thin_tile(d: int) -> int:
    """Columns a warp of the thin route sums: the narrowest instance that
    holds all d (a wider W runs in tiles of the widest)."""
    return next(t for t in _THIN_TILES if t >= min(d, _THIN_TILES[-1]))


def mix_matmul(m: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Y = M @ W with M (r, n) fp32 mixing weights, r ≤ n (the square
    operator, or a row block of it), and W (n, d) fp32 or bf16 node-major
    params; fp32 accumulation, Y (r, d) in W's dtype."""
    L.check_w(w)
    n, d = w.shape
    r = m.shape[0] if m.ndim == 2 else -1
    if not 0 <= r <= n:
        raise ValueError(f"M must be (r, {n}) with r <= {n}, got shape {tuple(m.shape)}")
    L.check_operand(m, "M", torch.float32, (r, n), w.device)
    if w.device.type == "cpu":
        return decavg_mix_ref(m, w)
    if r == 0 or d == 0:
        return torch.empty((r, d), dtype=w.dtype, device=w.device)
    route = dense_route(n, d, w.dtype)
    y = _launch(m, w, route)
    mix_matmul.launches += 1
    mix_matmul.launches_by_route[route] += 1
    return y


def _launch(m: torch.Tensor, w: torch.Tensor, route: str) -> torch.Tensor:
    """One launch of ``route`` on checked, non-empty CUDA tensors (either
    route takes any (r, n) M and (n, d) W); counts nothing."""
    n, d = w.shape
    r = m.shape[0]
    y = torch.empty((r, d), dtype=w.dtype, device=w.device)
    with torch.cuda.device(w.device):
        err = _lib().mix_dense(
            K.DTYPE_CODES[w.dtype], ROUTES.index(route), thin_tile(d), K.ptr(m), K.ptr(w), K.ptr(y), r, n, d,
            K.stream_of(w),
        )
    K.raise_on_error(err, f"mix_matmul ({route})")
    return y


mix_matmul.launches = 0
mix_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
