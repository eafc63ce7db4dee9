"""Quantised DecAvg mixing kernels (counterpart of ``repro/kernels/mix/quant.py``).

Three kernels of ``csrc/quant_mix.cu``, each behind a wrapper that launches
it on CUDA tensors, runs its plain version (``ref.py``) on CPU tensors and
raises on any other device; there is no fallback from a kernel to its
plain version.  ``<wrapper>.launches`` counts kernel launches.

* ``quant_scales`` — one fp32 absmax scale per (row, chunk) of ``X − H``.
* ``quant_mix_dense`` / ``quant_mix_bsr`` — ``M · (H + Q(X − H))`` with M
  dense or in BSR form, each source element dequantised in registers.
  Raw mode (``gamma=None``) returns Y = M·Q(X) in X's dtype; round mode
  returns one compressed gossip round, (X' = X + γ (M·H' − H'), H').

``quantised_mix_bsr`` is the Pallas kernel's function (raw mode, its
``block_d`` chunking and scale floor): scales, then the BSR walk.  A chunk
table ``bounds`` is (C + 1,) int64 column boundaries on X's device
(``ref.chunk_bounds`` / ``ref.pallas_bounds``); ``keep`` ((n,) bool) marks
the rows whose mirror updates (the others keep H).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _launch as K
from repro_torch.kernels.build import load_library

from . import _launch as L
from .ref import (
    check_codec,
    decavg_mix_ref,
    pallas_bounds,
    quant_mix_ref,
    quant_scales_ref,
)
from .sparse import MAX_BLOCK_N, mix_bsr_ref

__all__ = ["quant_mix_bsr", "quant_mix_dense", "quant_scales", "quantised_mix_bsr"]

CODEC_CODES = {"int8": 0, "fp8": 1}
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("quant_mix")
    for name, args in (
        ("quant_scales", [_I, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _P]),
        ("quant_mix_dense", [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _F, _I, _P]),
        ("quant_mix_bsr", [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I,
                           _I, _I, _F, _I, _P]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, args
    return lib


def _ptr(t: torch.Tensor | None):
    return None if t is None else K.ptr(t)


def _check_inputs(x, h, bounds, scales=None, keep=None) -> None:
    L.check_w(x)
    n, d = x.shape
    if h is not None:
        L.check_operand(h, "H", torch.float32, (n, d), x.device)
    if bounds.ndim != 1 or bounds.numel() < 2:
        raise ValueError(f"bounds must be (C + 1,) column boundaries, got {tuple(bounds.shape)}")
    L.check_operand(bounds, "bounds", torch.int64, bounds.shape, x.device)
    if scales is not None:
        L.check_operand(scales, "scales", torch.float32, (n, bounds.numel() - 1), x.device)
    if keep is not None:
        if h is None:
            raise ValueError("keep needs H: a row that does not update keeps its mirror")
        L.check_operand(keep, "keep", torch.bool, (n,), x.device)


def _vec(d: int, *tensors: torch.Tensor) -> int:
    """Widest of 4/2/1 elements per thread that divides d and keeps every
    row of every tensor aligned for one vector access."""
    for vec in (4, 2, 1):
        if d % vec == 0 and all(t.data_ptr() % (vec * t.element_size()) == 0 for t in tensors):
            return vec
    return 1


def quant_scales(
    x: torch.Tensor,
    h: torch.Tensor | None,
    bounds: torch.Tensor,
    *,
    codec: str,
    error_feedback: bool = True,
    floor: str = "codec",
) -> torch.Tensor:
    """(n, C) fp32: one absmax scale per (row, chunk) of ``X − H`` (of X
    when ``h`` is None or ``error_feedback`` is off).  ``floor`` "codec" or
    "pallas" (``ref.py``)."""
    check_codec(codec, floor)
    _check_inputs(x, h, bounds)
    ef = error_feedback and h is not None
    if x.device.type == "cpu":
        return quant_scales_ref(x, h, bounds, codec=codec, error_feedback=ef, floor=floor)
    n, d = x.shape
    scales = torch.empty(n, bounds.numel() - 1, dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return scales
    with torch.cuda.device(x.device):
        err = _lib().quant_scales(
            K.DTYPE_CODES[x.dtype], K.ptr(x), _ptr(h if ef else None), K.ptr(bounds), K.ptr(scales),
            n, d, bounds.numel() - 1, CODEC_CODES[codec], int(ef), int(floor == "pallas"), K.stream_of(x),
        )
    K.raise_on_error(err, "quant_scales")
    quant_scales.launches += 1
    return scales


def _outputs(x: torch.Tensor, gamma: float | None):
    """(y, x_out, h_out): raw mode writes y, round mode x_out and h_out."""
    if gamma is None:
        return torch.empty_like(x), None, None
    return None, torch.empty_like(x), torch.empty(x.shape, dtype=torch.float32, device=x.device)


def _result(y, x_out, h_out):
    return y if y is not None else (x_out, h_out)


def _check_mode(h, keep, gamma) -> None:
    if gamma is None and (h is not None or keep is not None):
        raise ValueError("raw mode (gamma=None) computes M·Q(X): it takes no H and no keep")


def quant_mix_dense(
    m: torch.Tensor,
    x: torch.Tensor,
    h: torch.Tensor | None,
    bounds: torch.Tensor,
    scales: torch.Tensor,
    *,
    codec: str,
    gamma: float | None = None,
    error_feedback: bool = True,
    keep: torch.Tensor | None = None,
):
    """M (n, n) fp32 dense: Y = M·Q(X) with ``gamma`` None, else one
    compressed round (X', H') with the scales ``quant_scales`` gave."""
    check_codec(codec)
    _check_mode(h, keep, gamma)
    _check_inputs(x, h, bounds, scales, keep)
    n, d = x.shape
    L.check_operand(m, "M", torch.float32, (n, n), x.device)
    ef = error_feedback and h is not None
    if x.device.type == "cpu":
        return quant_mix_ref(lambda hq: decavg_mix_ref(m, hq), x, h, bounds, scales, codec=codec,
                             gamma=gamma, error_feedback=ef, keep=keep)
    y, x_out, h_out = _outputs(x, gamma)
    if n == 0 or d == 0:
        return _result(y, x_out, h_out)
    vec = _vec(d, *(t for t in (x, h, y, x_out, h_out) if t is not None))
    with torch.cuda.device(x.device):
        err = _lib().quant_mix_dense(
            K.DTYPE_CODES[x.dtype], K.ptr(m), K.ptr(x), _ptr(h), _ptr(keep), K.ptr(bounds), K.ptr(scales),
            _ptr(y), _ptr(x_out), _ptr(h_out), n, d, bounds.numel() - 1, CODEC_CODES[codec], int(ef),
            1.0 if gamma is None else float(gamma), vec, K.stream_of(x),
        )
    K.raise_on_error(err, "quant_mix_dense")
    quant_mix_dense.launches += 1
    return _result(y, x_out, h_out)


def quant_mix_bsr(
    block_cols: torch.Tensor,
    tiles: torch.Tensor,
    counts: torch.Tensor,
    x: torch.Tensor,
    h: torch.Tensor | None,
    bounds: torch.Tensor,
    scales: torch.Tensor,
    *,
    codec: str,
    gamma: float | None = None,
    error_feedback: bool = True,
    keep: torch.Tensor | None = None,
):
    """``quant_mix_dense`` with M in BSR form (``sparse.bsr_from_dense``)."""
    check_codec(codec)
    _check_mode(h, keep, gamma)
    _check_inputs(x, h, bounds, scales, keep)
    n, d = x.shape
    if tiles.ndim != 4 or tiles.shape[2] != tiles.shape[3]:
        raise ValueError(f"tiles must be (nrb, max_nnz, bn, bn), got {tuple(tiles.shape)}")
    nrb, max_nnz, bn, _ = tiles.shape
    if not 1 <= bn <= MAX_BLOCK_N:
        raise ValueError(f"block size {bn} outside [1, {MAX_BLOCK_N}]")
    if nrb != -(-n // bn) or max_nnz < 1:
        raise ValueError(f"{nrb} row blocks of {bn} do not cover n = {n}")
    L.check_operand(tiles, "tiles", torch.float32, tiles.shape, x.device)
    L.check_operand(block_cols, "block_cols", torch.int32, (nrb, max_nnz), x.device)
    L.check_operand(counts, "counts", torch.int32, (nrb,), x.device)
    ef = error_feedback and h is not None
    if x.device.type == "cpu":
        return quant_mix_ref(lambda hq: mix_bsr_ref(block_cols, tiles, counts, hq), x, h, bounds, scales,
                             codec=codec, gamma=gamma, error_feedback=ef, keep=keep)
    y, x_out, h_out = _outputs(x, gamma)
    if n == 0 or d == 0:
        return _result(y, x_out, h_out)
    vec = _vec(d, *(t for t in (x, h, y, x_out, h_out) if t is not None))
    with torch.cuda.device(x.device):
        err = _lib().quant_mix_bsr(
            K.DTYPE_CODES[x.dtype], K.ptr(block_cols), K.ptr(tiles), K.ptr(counts), K.ptr(x), _ptr(h),
            _ptr(keep), K.ptr(bounds), K.ptr(scales), _ptr(y), _ptr(x_out), _ptr(h_out), n, d,
            bounds.numel() - 1, nrb, max_nnz, bn, CODEC_CODES[codec], int(ef),
            1.0 if gamma is None else float(gamma), vec, K.stream_of(x),
        )
    K.raise_on_error(err, "quant_mix_bsr")
    quant_mix_bsr.launches += 1
    return _result(y, x_out, h_out)


def quantised_mix_bsr(
    block_cols: torch.Tensor,
    tiles: torch.Tensor,
    counts: torch.Tensor,
    w: torch.Tensor,
    *,
    codec: str = "int8",
    block_d: int = 512,
) -> torch.Tensor:
    """Y = M @ Q(W) from the BSR form of M, W (n, d) fp32 or bf16, Y in W's
    dtype: the Pallas kernel's function, one scale per ``min(block_d,
    next_pow2(d))`` columns of a source row, its scale floor."""
    check_codec(codec)
    L.check_w(w)
    bounds = pallas_bounds(w.shape[1], block_d, w.device)
    scales = quant_scales(w, None, bounds, codec=codec, floor="pallas")
    return quant_mix_bsr(block_cols, tiles, counts, w, None, bounds, scales, codec=codec)


quant_scales.launches = 0
quant_mix_dense.launches = 0
quant_mix_bsr.launches = 0
