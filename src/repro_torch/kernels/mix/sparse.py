"""Block-sparse DecAvg mixing kernel  Y = M · W  (counterpart of ``repro/kernels/mix/sparse.py``).

M is lowered once, on the host, to BSR form: (bn × bn) tiles, keeping only
tiles with a nonzero.  ``bsr_from_dense`` returns exactly the JAX package's
``(block_cols, tiles)`` — short row blocks padded with zero tiles at column
block 0 — plus ``counts``, the number of real tiles per row block, which the
CUDA kernel (``csrc/mix_bsr.cu``) uses to skip the padding.

``mix_bsr`` launches that kernel on CUDA tensors and runs its plain version
``mix_bsr_ref`` (a loop over tiles) on CPU tensors; anything else raises.
``mix_bsr.launches`` counts kernel launches.  ``mix_bsr_rows_ref`` renders
the kernel's walk over the nonzeros of M bit for bit, for the tests.

M may be a row block: ``n_rows`` ≤ n output rows (nrb covers them) over a
W of n rows, its column blocks indexing all of W.  The node-sharded round
(``core/shardplan.py``) runs a rank's rows so, over its ``[local | halo]``
buffer; ``n_rows`` omitted is the square call, the unsharded plan's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _launch as K
from repro_torch.kernels.build import load_library

from . import _launch as L
from .ref import fma_f32

__all__ = ["BSR", "bsr_from_dense", "bsr_slots", "mix_bsr", "mix_bsr_ref", "mix_bsr_rows_ref"]

MAX_BLOCK_N = 256


class BSR(NamedTuple):
    """A BSR operator on one device: the three arrays ``mix_bsr`` takes."""

    block_cols: torch.Tensor  # (nrb, max_nnz) int32
    tiles: torch.Tensor  # (nrb, max_nnz, bn, bn) float32
    counts: torch.Tensor  # (nrb,) int32

    @property
    def block_n(self) -> int:
        return self.tiles.shape[-1]


def bsr_from_dense(m: np.ndarray, block_n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lower a dense (n, n) operator to padded BSR tiles on the host.

    Returns (block_cols (nrb, max_nnz) int32, tiles (nrb, max_nnz, bn, bn)
    float32, counts (nrb,) int32).  O(n²); runs once per operator.
    """
    m = np.asarray(m, dtype=np.float32)
    n = m.shape[0]
    bn = block_n
    n_pad = -n % bn
    if n_pad:
        m = np.pad(m, ((0, n_pad), (0, n_pad)))
    nb = m.shape[0] // bn
    tiles4 = m.reshape(nb, bn, nb, bn).transpose(0, 2, 1, 3)  # (nrb, ncb, bn, bn)
    nonzero = np.abs(tiles4).sum(axis=(2, 3)) > 0
    counts = nonzero.sum(axis=1).astype(np.int32)
    max_nnz = max(int(counts.max()), 1)
    block_cols = np.zeros((nb, max_nnz), dtype=np.int32)
    tiles = np.zeros((nb, max_nnz, bn, bn), dtype=np.float32)
    for i in range(nb):
        cols = np.nonzero(nonzero[i])[0]
        block_cols[i, : len(cols)] = cols
        tiles[i, : len(cols)] = tiles4[i, cols]
    return block_cols, tiles, counts


def bsr_slots(
    block_cols: np.ndarray, counts: np.ndarray, rows: np.ndarray, cols: np.ndarray, block_n: int
) -> np.ndarray:
    """Flat index into ``tiles`` of every entry (rows[e], cols[e]) of M.

    A masked round writes its renormalised weights straight into a zeroed
    tile array at these slots (each slot once, so nothing accumulates) and
    then runs the same kernel: dropping edges never changes the block
    structure.  Raises if an entry falls in a tile the structure lacks.
    """
    nrb, max_nnz = block_cols.shape
    bn = block_n
    # (row block, col block) → tile index; a row block of a larger operator
    # has more column blocks than row blocks
    ncb = max(nrb, int(block_cols.max(initial=0)) + 1)
    pos = np.full((nrb, ncb), -1, dtype=np.int64)
    for i in range(nrb):
        pos[i, block_cols[i, : counts[i]]] = np.arange(counts[i])
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    t = pos[rows // bn, cols // bn]
    if np.any(t < 0):
        raise ValueError("an entry lies in a tile the BSR structure does not keep")
    return ((((rows // bn) * max_nnz + t) * bn + rows % bn) * bn + cols % bn).astype(np.int64)


def mix_bsr_ref(
    block_cols: torch.Tensor, tiles: torch.Tensor, counts: torch.Tensor, w: torch.Tensor, n_rows: int | None = None
) -> torch.Tensor:
    """Plain version: walk each row block's real tiles in order, fp32
    accumulation, Y (n_rows, d) in W's dtype (n_rows omitted: W's n)."""
    n, d = w.shape
    n_rows = n if n_rows is None else n_rows
    nrb, _, bn, _ = tiles.shape
    wf = w.to(torch.float32)
    tf = tiles.to(torch.float32)
    out = torch.zeros(nrb * bn, d, dtype=torch.float32, device=w.device)
    cols = block_cols.tolist()
    for i, cnt in enumerate(counts.tolist()):
        acc = out[i * bn : (i + 1) * bn]
        for t in range(cnt):
            lo = cols[i][t] * bn
            hi = min(lo + bn, n)
            if hi > lo:
                acc += tf[i, t, :, : hi - lo] @ wf[lo:hi]
    return out[:n_rows].to(w.dtype)


def mix_bsr_rows_ref(
    block_cols: torch.Tensor, tiles: torch.Tensor, counts: torch.Tensor, w: torch.Tensor, n_rows: int | None = None
) -> torch.Tensor:
    """Plain rendering of the CUDA walk (``csrc/bsr_walk.cuh``), bit for bit.

    Each output row takes the nonzeros of its row block's real tiles in
    tile order ``t < counts[i]``, then ascending column inside the tile;
    exact zeros, padding tiles and source rows outside ``[0, n)`` are
    skipped.  From zero, one fp32 FMA per nonzero in that order
    (``ref.fma_f32``); Y (n_rows, d) in W's dtype.  For the tests: the
    wrapper's CPU path is ``mix_bsr_ref``.
    """
    n, d = w.shape
    n_rows = n if n_rows is None else n_rows
    nrb, max_nnz, bn, _ = tiles.shape
    dev = w.device
    srcs, wts = [], []
    for i, cnt in enumerate(counts.tolist()):
        nt = max(0, min(cnt, max_nnz))
        src = (block_cols[i, :nt].to(torch.int64)[:, None] * bn + torch.arange(bn, device=dev)).reshape(1, -1)
        wt = tiles[i, :nt].to(torch.float32).transpose(0, 1).reshape(bn, nt * bn)  # row rr: (t, c) order
        kept = (wt != 0) & (src >= 0) & (src < n)
        order = torch.argsort((~kept).to(torch.int8), dim=1, stable=True)  # kept entries first, in order
        srcs.append(torch.where(kept, src, -1).gather(1, order))
        wts.append(torch.where(kept, wt, 0.0).gather(1, order))
    length = max([int((s >= 0).sum(1).max()) if s.numel() else 0 for s in srcs], default=0)

    def fit(t, fill):  # every row block's lists to one length
        return torch.nn.functional.pad(t[:, :length], (0, max(0, length - t.shape[1])), value=fill)

    src = torch.cat([fit(s, -1) for s in srcs])[:n_rows]
    wt = torch.cat([fit(x, 0.0) for x in wts])[:n_rows]
    wf = w.to(torch.float32)
    acc = torch.zeros(n_rows, d, dtype=torch.float32, device=dev)
    for e in range(length):
        s_e = src[:, e]
        acc = torch.where((s_e >= 0)[:, None], fma_f32(wt[:, e : e + 1], wf[s_e.clamp_min(0)], acc), acc)
    return acc.to(w.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("mix_bsr")
    lib.mix_bsr.restype = ctypes.c_int
    lib.mix_bsr.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def mix_bsr(
    block_cols: torch.Tensor, tiles: torch.Tensor, counts: torch.Tensor, w: torch.Tensor, n_rows: int | None = None
) -> torch.Tensor:
    """Y = M @ W from the BSR form of M; W is (n, d) node-major params, Y
    (n_rows, d), ``n_rows`` ≤ n (omitted: n, the square operator).

    The kernel reads W rows only inside [0, n), whatever ``block_cols``
    holds, and walks at most ``max_nnz`` tiles per row block.
    """
    L.check_w(w)
    n, d = w.shape
    n_rows = n if n_rows is None else int(n_rows)
    if not 0 <= n_rows <= n:
        raise ValueError(f"n_rows = {n_rows} outside [0, {n}]")
    if tiles.ndim != 4 or tiles.shape[2] != tiles.shape[3]:
        raise ValueError(f"tiles must be (nrb, max_nnz, bn, bn), got {tuple(tiles.shape)}")
    nrb, max_nnz, bn, _ = tiles.shape
    if not 1 <= bn <= MAX_BLOCK_N:
        raise ValueError(f"block size {bn} outside [1, {MAX_BLOCK_N}]")
    if nrb != -(-n_rows // bn) or max_nnz < 1:
        raise ValueError(f"{nrb} row blocks of {bn} do not cover {n_rows} rows")
    L.check_operand(tiles, "tiles", torch.float32, tiles.shape, w.device)
    L.check_operand(block_cols, "block_cols", torch.int32, (nrb, max_nnz), w.device)
    L.check_operand(counts, "counts", torch.int32, (nrb,), w.device)
    if w.device.type == "cpu":
        return mix_bsr_ref(block_cols, tiles, counts, w, n_rows)
    y = torch.empty((n_rows, d), dtype=w.dtype, device=w.device)
    if n_rows == 0 or d == 0:
        return y
    with torch.cuda.device(w.device):
        err = _lib().mix_bsr(
            K.DTYPE_CODES[w.dtype], K.ptr(block_cols), K.ptr(tiles), K.ptr(counts),
            K.ptr(w), K.ptr(y), n, n_rows, d, nrb, max_nnz, bn, L.vec_width(w, y), K.stream_of(w),
        )
    K.raise_on_error(err, "mix_bsr")
    mix_bsr.launches += 1
    return y


mix_bsr.launches = 0
