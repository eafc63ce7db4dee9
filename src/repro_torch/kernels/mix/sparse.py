"""Block-sparse DecAvg mixing kernel  Y = M · W  (counterpart of ``repro/kernels/mix/sparse.py``).

M is lowered once, on the host, to BSR form: (bn × bn) tiles, keeping only
tiles with a nonzero.  ``bsr_from_dense`` returns exactly the JAX package's
``(block_cols, tiles)`` — short row blocks padded with zero tiles at column
block 0 — plus ``counts``, the number of real tiles per row block, which the
CUDA kernel (``csrc/mix_bsr.cu``) uses to skip the padding.

``mix_bsr`` launches that kernel on CUDA tensors and runs its plain version
``mix_bsr_ref`` (a loop over tiles) on CPU tensors; anything else raises.
``mix_bsr.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.build import load_library

from . import _launch as L

__all__ = ["BSR", "bsr_from_dense", "bsr_slots", "mix_bsr", "mix_bsr_ref"]

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
    pos = np.full((nrb, nrb), -1, dtype=np.int64)  # (row block, col block) → tile index
    for i in range(nrb):
        pos[i, block_cols[i, : counts[i]]] = np.arange(counts[i])
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    t = pos[rows // bn, cols // bn]
    if np.any(t < 0):
        raise ValueError("an entry lies in a tile the BSR structure does not keep")
    return ((((rows // bn) * max_nnz + t) * bn + rows % bn) * bn + cols % bn).astype(np.int64)


def mix_bsr_ref(
    block_cols: torch.Tensor, tiles: torch.Tensor, counts: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """Plain version: walk each row block's real tiles in order, fp32
    accumulation, Y in W's dtype."""
    n, d = w.shape
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
    return out[:n].to(w.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("mix_bsr")
    lib.mix_bsr.restype = ctypes.c_int
    lib.mix_bsr.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def mix_bsr(
    block_cols: torch.Tensor, tiles: torch.Tensor, counts: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """Y = M @ W from the BSR form of M; W is (n, d) node-major params.

    The kernel reads W rows only inside [0, n), whatever ``block_cols``
    holds, and walks at most ``max_nnz`` tiles per row block.
    """
    L.check_w(w)
    n, d = w.shape
    if tiles.ndim != 4 or tiles.shape[2] != tiles.shape[3]:
        raise ValueError(f"tiles must be (nrb, max_nnz, bn, bn), got {tuple(tiles.shape)}")
    nrb, max_nnz, bn, _ = tiles.shape
    if not 1 <= bn <= MAX_BLOCK_N:
        raise ValueError(f"block size {bn} outside [1, {MAX_BLOCK_N}]")
    if nrb != -(-n // bn) or max_nnz < 1:
        raise ValueError(f"{nrb} row blocks of {bn} do not cover n = {n}")
    L.check_operand(tiles, "tiles", torch.float32, tiles.shape, w.device)
    L.check_operand(block_cols, "block_cols", torch.int32, (nrb, max_nnz), w.device)
    L.check_operand(counts, "counts", torch.int32, (nrb,), w.device)
    if w.device.type == "cpu":
        return mix_bsr_ref(block_cols, tiles, counts, w)
    y = torch.empty_like(w)
    if n == 0 or d == 0:
        return y
    with torch.cuda.device(w.device):
        err = _lib().mix_bsr(
            L.DTYPE_CODES[w.dtype], L.ptr(block_cols), L.ptr(tiles), L.ptr(counts),
            L.ptr(w), L.ptr(y), n, d, nrb, max_nnz, bn, L.vec_width(w, y), L.stream_of(w),
        )
    L.raise_on_error(err, "mix_bsr")
    mix_bsr.launches += 1
    return y


mix_bsr.launches = 0
