"""Quantised DecAvg mixing kernels (counterpart of ``repro/kernels/mix/quant.py``).

The kernels of ``csrc/quant_mix.cu``, each behind a wrapper that launches
it on CUDA tensors, runs its plain version (``ref.py``) on CPU tensors and
raises on any other device; there is no fallback from a kernel to its
plain version.  ``<wrapper>.launches`` counts kernel launches.

* ``quant_mix_dense`` — one quantised round with M dense, one launch: the
  (row, chunk) absmax scales of ``X − H``, the decode ``H' = H + Q(X − H)``
  and the mix, in one pass over X and H; it returns the scales it used
  beside its result.  The chunk table is cut into column tiles once per
  table (``plan_tiles``, cached by ``tile_plan``); a tile wider than a
  thread-block cluster stages takes the ``wide`` route, the others the
  ``staged`` one (``quant_mix_dense.launches_by_route``).
* ``quant_scales`` — one fp32 absmax scale per (row, chunk) of ``X − H``.
* ``quant_mix_bsr`` — ``M · (H + Q(X − H))`` with M in BSR form and the
  scales ``quant_scales`` gave.
* ``quant_mix_pair`` — one compressed exchange of an asynchronous event
  over its two endpoint rows, route ``pair``: on the card one launch of a
  kernel of its own (``quant_pair_kernel``: a block walks two chunks,
  both rows in registers; ``pair_launch`` sizes its grid), the dense round's
  arithmetic at n = 2 bit for bit; its plain version mixes in the JAX
  package's pairwise form (``ref.pair_mix_ref``), and ``ref.pair_round_ref``
  is the kernel's own arithmetic.

Raw mode (``gamma=None``) gives Y = M·Q(X) in X's dtype; round mode one
compressed gossip round, (X' = X + γ (M·H' − H'), H').

``quantised_mix_bsr`` is the Pallas kernel's function (raw mode, its
``block_d`` chunking and scale floor): scales, then the BSR walk.  A chunk
table ``bounds`` is (C + 1,) int64 column boundaries on X's device
(``ref.chunk_bounds`` / ``ref.pallas_bounds``); the dense round takes the
same table as host ints, ``edges``, and makes its device copy and its tile
plan from them once per table (``table_bounds``, ``tile_plan``), so that
the two never differ and no round copies from the device.  ``keep`` ((n,)
bool) marks the rows whose mirror updates (the others keep H).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _launch as K
from repro_torch.kernels.build import load_library

from . import _launch as L
from .ref import (
    check_codec,
    decavg_mix_ref,
    pair_mix_ref,
    pallas_bounds,
    quant_mix_ref,
    quant_scales_ref,
)
from .sparse import MAX_BLOCK_N, mix_bsr_ref

__all__ = ["ROUTES", "TilePlan", "pair_launch", "plan_tiles", "quant_mix_bsr", "quant_mix_dense", "quant_mix_pair",
           "quant_scales", "quantised_mix_bsr", "round_smem_bytes", "table_bounds", "tile_plan"]

CODEC_CODES = {"int8": 0, "fp8": 1}
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("quant_mix")
    for name, args in (
        ("quant_scales", [_I, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _P]),
        ("quant_mix_dense", [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _I, _I,
                             _I, _F, _P]),
        ("quant_mix_bsr", [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I,
                           _I, _I, _F, _I, _P]),
        ("quant_mix_pair", [_I, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _F, _P]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, args
    lib.quant_round_smem_bytes.restype = ctypes.c_longlong
    lib.quant_round_smem_bytes.argtypes = [_I, _I, _I, _I]
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


# ------------------------------------------------------------ the dense round
ROUTES = ("staged", "wide")
MAX_CLUSTER = 8  # CTAs of a tile: the portable cluster size
M_RESIDENT_MAX = 128  # M sits in shared memory up to this n (kMResidentMax)
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on sm_90 (kSmemLimit)
STAGE_BYTES = 32 * 1024  # the X and H' a CTA aims to stage


def round_smem_bytes(n: int, cols: int, tile_chunks: int, x_itemsize: int) -> int:
    """Dynamic shared memory of the round kernel (``csrc/quant_mix.cu::RoundSmem``;
    the library's ``quant_round_smem_bytes`` gives the kernel's own count)."""
    a16 = lambda b: -(-b // 16) * 16  # noqa: E731
    rg = 8 if n <= 8 else 16  # a warp's output rows in the mix (dispatch_round)
    e, n4 = 16 // x_itemsize, -(-n // 4) * 4
    sx, sh = -(-cols // e) * e + e, -(-cols // 4) * 4 + 4
    m_bytes = 4 * (-(-n // rg) * rg) * n if n <= M_RESIDENT_MAX else 0
    parts = 2 * a16(4 * MAX_CLUSTER * n * tile_chunks) + a16(4 * n * tile_chunks)  # every CTA's partials, scales
    return (a16(m_bytes) + parts + a16(8 * (tile_chunks + 1)) + a16(cols) + 2 * a16(4 * n4) + a16(n)
            + a16(x_itemsize * n * sx) + a16(4 * n * sh))


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The dense round's launch: ``tiles`` are (first column, end column,
    first chunk, end chunk), each taken by one cluster of ``cluster`` CTAs
    that stage ``cols`` columns of every row at a time; ``tile_chunks``
    bounds the chunks of a tile."""

    tiles: tuple[tuple[int, int, int, int], ...]
    cluster: int
    cols: int
    tile_chunks: int

    @property
    def route(self) -> str:
        """``wide`` when some tile is one chunk wider than a cluster stages."""
        return ROUTES[any(hi - lo > self.cluster * self.cols for lo, hi, _, _ in self.tiles)]


def plan_tiles(edges, n: int, x_itemsize: int = 4) -> TilePlan:
    """Cut the chunk table ``edges`` (C + 1 column boundaries) into the
    round kernel's tiles for n rows of X elements of ``x_itemsize`` bytes.

    A CTA stages ``cols`` columns of X and H' for every row: about
    ``STAGE_BYTES``, or more where the widest chunk would otherwise need
    more than ``MAX_CLUSTER`` CTAs, within the shared memory of a block.  A
    cluster is the fewest CTAs (a power of two) that cover the widest chunk.
    Tiles hold consecutive whole chunks up to a cluster's columns; a chunk
    wider than that is a tile of its own and takes the wide route.
    """
    edges = [int(e) for e in edges]
    if n < 1 or len(edges) < 2:
        raise ValueError(f"a round needs rows and chunks, got n = {n} and {len(edges) - 1} chunks")
    widths = [b - a for a, b in zip(edges, edges[1:])]
    widest = max(widths)
    tc = max(1, min(16, 512 // n))
    per_col = n * (x_itemsize + 4)
    cols_max = (SMEM_LIMIT - round_smem_bytes(n, 0, tc, x_itemsize)) // (per_col + 1)
    while cols_max > 0 and round_smem_bytes(n, cols_max, tc, x_itemsize) > SMEM_LIMIT:
        cols_max -= 1
    if cols_max < 1:
        raise ValueError(f"{n} rows do not fit the dense round's shared memory: use the sparse backend")
    cols = min(cols_max, max(1, STAGE_BYTES // per_col, -(-widest // MAX_CLUSTER)))
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * cols < widest:
        cluster *= 2
    limit = cluster * cols
    tiles, cur = [], None
    for j, w in enumerate(widths):
        if w > limit:
            if cur is not None:
                tiles.append(tuple(cur))
                cur = None
            tiles.append((edges[j], edges[j + 1], j, j + 1))
            continue
        if cur is not None and (edges[j + 1] - cur[0] > limit or j - cur[2] >= tc):
            tiles.append(tuple(cur))
            cur = None
        if cur is None:
            cur = [edges[j], edges[j + 1], j, j + 1]
        else:
            cur[1], cur[3] = edges[j + 1], j + 1
    if cur is not None:
        tiles.append(tuple(cur))
    return TilePlan(tuple(tiles), cluster, cols, tc)


@functools.lru_cache(maxsize=64)
def table_bounds(edges: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The chunk table ``edges`` (C + 1 column boundaries from 0, host ints)
    as the (C + 1,) int64 ``bounds`` on ``device``, made once per table."""
    if len(edges) < 2 or edges[0] != 0 or any(b < a for a, b in zip(edges, edges[1:])):
        raise ValueError(f"edges must rise from 0 over at least one chunk, got {edges[:4]}...")
    return torch.tensor(edges, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=64)
def tile_plan(edges: tuple[int, ...], n: int, dtype: torch.dtype, device: torch.device) -> tuple[TilePlan, torch.Tensor]:
    """``plan_tiles`` and its tiles as an (T, 4) int64 tensor on ``device``,
    built once per chunk table, row count, dtype and device."""
    plan = plan_tiles(edges, n, torch.empty((), dtype=dtype).element_size())
    return plan, torch.tensor(plan.tiles, dtype=torch.int64, device=device)


def quant_mix_dense(
    m: torch.Tensor,
    x: torch.Tensor,
    h: torch.Tensor | None,
    edges: tuple[int, ...],
    *,
    codec: str,
    gamma: float | None = None,
    error_feedback: bool = True,
    keep: torch.Tensor | None = None,
    floor: str = "codec",
):
    """M (n, n) fp32 dense: one quantised round, one launch, over the chunk
    table ``edges`` (host ints, 0 … d).  Returns ``(Y, scales)`` with
    ``gamma`` None (Y = M·Q(X)), else ``((X', H'), scales)``; scales are
    the (n, C) fp32 scales of ``X − H`` (of X without error feedback) under
    ``floor``, what ``quant_scales`` gives."""
    check_codec(codec, floor)
    _check_mode(h, keep, gamma)
    edges = tuple(edges)
    bounds = table_bounds(edges, x.device)
    _check_inputs(x, h, bounds, None, keep)
    n, d = x.shape
    if edges[-1] != d:
        raise ValueError(f"the chunk table ends at column {edges[-1]}, X has {d}")
    L.check_operand(m, "M", torch.float32, (n, n), x.device)
    ef = error_feedback and h is not None
    if x.device.type == "cpu":
        scales = quant_scales_ref(x, h, bounds, codec=codec, error_feedback=ef, floor=floor)
        return quant_mix_ref(lambda hq: decavg_mix_ref(m, hq), x, h, bounds, scales, codec=codec,
                             gamma=gamma, error_feedback=ef, keep=keep), scales
    y, x_out, h_out = _outputs(x, gamma)
    n_chunks = bounds.numel() - 1
    scales = torch.empty(n, n_chunks, dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return _result(y, x_out, h_out), scales
    plan, table = tile_plan(edges, n, x.dtype, x.device)
    with torch.cuda.device(x.device):
        err = _lib().quant_mix_dense(
            K.DTYPE_CODES[x.dtype], K.ptr(m), K.ptr(x), _ptr(h), _ptr(keep), K.ptr(bounds), K.ptr(table),
            K.ptr(scales), _ptr(y), _ptr(x_out), _ptr(h_out), n, d, n_chunks, len(plan.tiles), plan.cluster,
            plan.cols, plan.tile_chunks, CODEC_CODES[codec], int(ef), int(floor == "pallas"),
            1.0 if gamma is None else float(gamma), K.stream_of(x),
        )
    K.raise_on_error(err, "quant_mix_dense")
    quant_mix_dense.launches += 1
    quant_mix_dense.launches_by_route[plan.route] += 1
    return _result(y, x_out, h_out), scales


# ------------------------------------------------------------ the pair exchange
PAIR_SLOTS = 2  # a thread's groups of 4 columns in a one-pass chunk (kPairSlots)
PAIR_MAX_THREADS = 512  # the pair kernel's block at most (kPairMaxThreads)
PAIR_CHUNKS_PER_BLOCK = 2  # chunks a block walks, the next one's loads in flight during this one


@functools.lru_cache(maxsize=64)
def pair_launch(edges: tuple[int, ...]) -> tuple[int, int, int]:
    """The pair kernel's launch for the chunk table ``edges``: (threads,
    blocks, passes).  A block walks ``PAIR_CHUNKS_PER_BLOCK`` chunks; its
    threads are the fewest warps that hold the widest chunk's groups of 4
    columns (one more for a chunk that starts mid-group), ``PAIR_SLOTS`` a
    thread, up to ``PAIR_MAX_THREADS``.  A chunk wider than that takes two
    passes (its absmax from device memory, then decode and mix)."""
    widths = [b - a for a, b in zip(edges, edges[1:])]
    groups = -(-max(widths, default=0) // 4) + 1
    threads = min(PAIR_MAX_THREADS, max(32, -(-groups // (PAIR_SLOTS * 32)) * 32))
    return threads, -(-len(widths) // PAIR_CHUNKS_PER_BLOCK), 1 if groups <= PAIR_SLOTS * threads else 2


def quant_mix_pair(
    m2: torch.Tensor,
    x: torch.Tensor,
    h: torch.Tensor | None,
    edges: tuple[int, ...],
    *,
    codec: str,
    gamma: float,
    error_feedback: bool = True,
):
    """One compressed exchange of an asynchronous event: ``x`` / ``h`` are
    the (2, d) rows and fp32 mirrors of its endpoints u and v, ``m2`` the
    (2, 2) operator ``[[1 − w_uv, w_uv], [w_vu, 1 − w_vu]]``
    (``CommPlan.event_m2``), ``edges`` the chunk table as host ints.
    Returns ``((X', H'), scales)`` as ``quant_mix_dense``.

    On CUDA tensors it is one launch of the pair kernel (route ``pair``,
    counted by ``quant_mix_pair.launches``): the scales, H' and X' of the
    dense round at n = 2, bit for bit (``ref.pair_round_ref``).  On CPU
    tensors it runs the plain version, the JAX package's compressed event:
    the same scales and H', and the mix in its pairwise form ``h'_u +
    w_uv·(h'_v − h'_u)``, where the kernel sums ``(1 − w_uv)·h'_u +
    w_uv·h'_v``: X' differs by fp32 rounding only."""
    if x.ndim != 2 or x.shape[0] != 2:
        raise ValueError(f"a pair exchange takes (2, d) rows, got {tuple(x.shape)}")
    L.check_operand(m2, "M", torch.float32, (2, 2), x.device)
    check_codec(codec)
    edges = tuple(edges)
    bounds = table_bounds(edges, x.device)
    _check_inputs(x, h, bounds)
    d = x.shape[1]
    if edges[-1] != d:
        raise ValueError(f"the chunk table ends at column {edges[-1]}, X has {d}")
    ef = error_feedback and h is not None
    if x.device.type == "cpu":
        scales = quant_scales_ref(x, h, bounds, codec=codec, error_feedback=ef)
        w = torch.stack([m2[0, 1], m2[1, 0]])
        out = quant_mix_ref(lambda hq: pair_mix_ref(hq, w), x, h, bounds, scales, codec=codec, gamma=gamma,
                            error_feedback=ef)
        return out, scales
    n_chunks = bounds.numel() - 1
    scales = torch.empty(2, n_chunks, dtype=torch.float32, device=x.device)
    _, x_out, h_out = _outputs(x, gamma)
    if d == 0:
        return (x_out, h_out), scales
    threads, blocks, _ = pair_launch(edges)
    with torch.cuda.device(x.device):
        err = _lib().quant_mix_pair(
            K.DTYPE_CODES[x.dtype], K.ptr(m2), K.ptr(x), _ptr(h if ef else None), K.ptr(bounds), K.ptr(scales),
            K.ptr(x_out), K.ptr(h_out), d, n_chunks, threads, blocks, CODEC_CODES[codec], int(ef), float(gamma),
            K.stream_of(x),
        )
    K.raise_on_error(err, "quant_mix_pair")
    quant_mix_pair.launches += 1
    return (x_out, h_out), scales


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
    """M in BSR form (``sparse.bsr_from_dense``): Y = M·Q(X) with ``gamma``
    None, else one compressed round (X', H'), with the scales
    ``quant_scales`` gave."""
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
quant_mix_dense.launches_by_route = dict.fromkeys(ROUTES, 0)
quant_mix_bsr.launches = 0
quant_mix_pair.launches = 0
