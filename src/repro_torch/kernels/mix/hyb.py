"""Row-list (HYB) DecAvg mixing kernel  Y = M · W: the sparse backend's
static-topology round (counterpart of ``repro/core/decavg.py::mix_pytree_hyb``;
the JAX package renders it in XLA, with no ``pallas_call``).

M comes in the HYB layout ``compile_plan`` builds (``core/commplan.py::
_hyb_layout``, the JAX package's tables): each row that is not a hub has
``S`` ELL slots (source row ``slot_idx[s, i]``, weight ``slot_w[s, i]``,
weight 0 for padding) and a self weight; the few heavy hub rows hold their
whole receive row, ``hub_m`` (H, n).  ``hyb_from_tables`` turns those tables
into the ``HYB`` operator the kernel reads, the hub rows compacted to their
nonzeros.

``mix_hyb`` launches the CUDA kernel of ``csrc/mix_hyb.cu`` on CUDA tensors
and runs its plain version ``mix_hyb_ref`` on CPU tensors; anything else
raises, and there is no fallback from the kernel to the plain version.
The kernel has two routes: ``"slab"`` (a block stages a column strip of
every source row in shared memory and gathers from there) and ``"rows"``
(blocks of output rows gathering from device memory).  ``hyb_route`` picks
one from the operator's shape (its output rows, ELL width and hub rows),
W's dtype and width and the rows the slab would stage (``route_of`` reads
them off a call's arguments): the rule the card's timings in turns gave.  No pointer
enters the choice, so chunked and resumed runs sum alike; the two routes
sum in the same order and give the same bits.  ``mix_hyb.launches`` counts kernel
launches and ``mix_hyb.launches_by_route`` splits them by route.  The plain
version is the kernel's arithmetic bit for bit: each ELL row ``self_w·x[i]``, then each
slot in order ``+ slot_w·x[src]`` (the product and the sum rounded
separately, a weight of exactly 0 skipped), each hub row one fp32 FMA chain
from 0 over its nonzeros, ascending column.

M may be a row block: ``n_rows`` output rows (the tables' width) over a W of
more rows, and the hub lists may index a second buffer ``w_hub``.  The
node-sharded round (``core/shardplan.py``) runs a rank's rows so: the slots
over its ``[local | halo]`` buffer, the hubs over the all-gathered payload.
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

__all__ = ["FEW_ROWS", "FEW_ROWS_MIN_D", "HYB", "ROUTES", "SLAB_MAX_ROWS", "THIN_SLOTS", "hyb_from_tables",
           "hyb_route", "mix_hyb", "mix_hyb_ref", "route_of"]

ROUTES = ("slab", "rows")
# the most source rows the slab route stages: 160 bytes a row (a 128-byte
# strip and the 32-byte sector before it), and 16 for an output row's info
# (there are no more output rows than staged ones), beside a row of zeros
# in the 227 KB a block may take (mix_hyb.cu's kSlabMaxRows, which the card
# tests hold this equal to)
SLAB_MAX_ROWS = 1319
# hyb_route's rule (PERF.md, row 2y): the rows route for up to FEW_ROWS
# fp32 output rows (half as many bf16 ones) of at least FEW_ROWS_MIN_D
# columns, and in fp32 for an operator without hub rows whose ELL rows hold
# at most 1 + THIN_SLOTS entries
FEW_ROWS = 64
FEW_ROWS_MIN_D = 65_536
THIN_SLOTS = 2


class HYB(NamedTuple):
    """A HYB operator on one device: the arrays ``mix_hyb`` takes."""

    slot_idx: torch.Tensor  # (S, n_rows) int32 source row of each ELL slot
    slot_w: torch.Tensor  # (S, n_rows) float32 slot weight, 0 for padding
    self_w: torch.Tensor  # (n_rows,) float32 self weight of an ELL row
    hub_rows: torch.Tensor  # (H,) int32 output row of each hub
    hub_of: torch.Tensor  # (n_rows,) int32 hub index of each row, -1 for an ELL row
    hub_ptr: torch.Tensor  # (H + 1,) int32 start of each hub's nonzeros
    hub_col: torch.Tensor  # (nnz,) int32 source row of each hub nonzero
    hub_val: torch.Tensor  # (nnz,) float32 its weight
    # the slab route's lists: walk (n_rows, 4) int32, the rows heaviest first
    # (the order it deals them to warps) as (row, first entry, entries, 1 for
    # a hub row); entries (n_ent, 2) int32, (source row, the fp32 weight's
    # bits): an ELL row's self term, then its live slots; a hub's nonzeros;
    # the lists one after another in the walk's order.  hyb_from_tables
    # builds both from the tables: replace a table, and build the operator
    # again
    walk: torch.Tensor
    entries: torch.Tensor

    @property
    def n_rows(self) -> int:
        return self.self_w.shape[0]

    @property
    def n_hubs(self) -> int:
        return self.hub_rows.shape[0]


def hyb_from_tables(slot_idx, slot_w, self_w, hub_rows, hub_m, device) -> HYB:
    """The ``HYB`` operator of the JAX-form tables (numpy arrays or tensors):
    ``slot_idx`` / ``slot_w`` (S, n_rows), ``self_w`` (n_rows,), ``hub_rows``
    (H,) and ``hub_m`` (H, n_src), each hub row's nonzeros kept in ascending
    column, and the slab route's lists: each row's entries (an ELL row's
    self term, then its slots of nonzero weight in slot order; a hub row's
    nonzeros), and ``walk``, the rows by their entries, most first, ties in
    row order.  Built on the host, once per operator."""
    host = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)  # noqa: E731
    slot_idx, slot_w, self_w = host(slot_idx), host(slot_w), host(self_w)
    hub_rows, hub_m = host(hub_rows).astype(np.int64), host(hub_m).astype(np.float32)
    n_rows = self_w.shape[0]
    hub_of = np.full(n_rows, -1, np.int32)
    hub_of[hub_rows] = np.arange(len(hub_rows), dtype=np.int32)
    hubs, cols = np.nonzero(hub_m)  # row-major: each hub's columns ascending
    hub_ptr = np.searchsorted(hubs, np.arange(len(hub_rows) + 1)).astype(np.int32)
    slot_idx, slot_w = slot_idx.reshape(-1, n_rows), slot_w.reshape(-1, n_rows).astype(np.float32)
    # each row's entries, a hub row's nonzeros or an ELL row's self term and
    # live slots (slot order: the nonzero weights of column i, top down),
    # the rows' lists one after another in the walk's order
    is_hub = hub_of >= 0
    live = (slot_w != 0) & ~is_hub[None, :]
    count = np.where(is_hub, 0, live.sum(0) + 1)
    count[hub_rows] = np.diff(hub_ptr)
    order = np.argsort(-count, kind="stable")  # the walk; the lists lie in its order
    first = np.empty_like(count)
    first[order] = np.concatenate([[0], np.cumsum(count[order])[:-1]])
    ent = np.zeros((int(count.sum()), 2), np.int32)
    ell = np.flatnonzero(~is_hub)
    ent[first[ell], 0] = ell
    ent[first[ell], 1] = self_w.astype(np.float32)[ell].view(np.int32)
    s_live, r_live = np.nonzero(live.T)[::-1]  # by row, then slot
    rank = np.arange(len(r_live)) - np.searchsorted(r_live, r_live)
    ent[first[r_live] + 1 + rank, 0] = slot_idx[s_live, r_live]
    ent[first[r_live] + 1 + rank, 1] = slot_w[s_live, r_live].view(np.int32)
    for h, row in enumerate(hub_rows):
        e = slice(first[row], first[row] + count[row])
        ent[e, 0] = cols[hub_ptr[h] : hub_ptr[h + 1]]
        ent[e, 1] = hub_m[h, ent[e, 0]].view(np.int32)
    walk = np.stack([order, first[order], count[order], is_hub[order]], 1)
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)  # noqa: E731
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)  # noqa: E731
    return HYB(
        slot_idx=i32(slot_idx.reshape(-1, n_rows)), slot_w=f32(slot_w.reshape(-1, n_rows)), self_w=f32(self_w),
        hub_rows=i32(hub_rows), hub_of=i32(hub_of), hub_ptr=i32(hub_ptr), hub_col=i32(cols),
        hub_val=f32(hub_m[hubs, cols]), walk=i32(walk), entries=i32(ent),
    )


def mix_hyb_ref(op: HYB, w: torch.Tensor, w_hub: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: Y (n_rows, d) in W's dtype, the kernel's sums in the
    kernel's order (the ELL chain with separate roundings, the hub rows'
    FMA chains through ``ref.fma_f32``)."""
    n_rows = op.n_rows
    wf = w.to(torch.float32)
    acc = op.self_w[:, None] * wf[:n_rows]
    for s in range(op.slot_idx.shape[0]):
        ws = op.slot_w[s][:, None]
        acc = torch.where(ws != 0, acc + ws * wf[op.slot_idx[s].long()], acc)
    if op.n_hubs:
        hf = wf if w_hub is None else w_hub.to(torch.float32)
        counts = (op.hub_ptr[1:] - op.hub_ptr[:-1]).long()
        length = int(counts.max())
        pos = op.hub_ptr[:-1].long()[:, None] + torch.arange(length, device=w.device)[None, :]
        live = torch.arange(length, device=w.device)[None, :] < counts[:, None]
        pos = torch.where(live, pos, 0)
        col, val = op.hub_col.long()[pos], op.hub_val[pos]
        hub = torch.zeros(op.n_hubs, w.shape[1], dtype=torch.float32, device=w.device)
        for e in range(length):
            hub = torch.where(live[:, e : e + 1], fma_f32(val[:, e : e + 1], hf[col[:, e]], hub), hub)
        acc = acc.index_copy(0, op.hub_rows.long(), hub)
    return acc.to(w.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("mix_hyb")
    lib.mix_hyb.restype = ctypes.c_int
    lib.mix_hyb.argtypes = [
        ctypes.c_int, *([ctypes.c_void_p] * 10), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mix_hyb_slab.restype = ctypes.c_int
    lib.mix_hyb_slab.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, *([ctypes.c_void_p] * 3),
        *([ctypes.c_int] * 4), ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mix_hyb_slab_max_rows.restype = ctypes.c_int
    lib.mix_hyb_slab_max_rows.argtypes = []
    return lib


def hyb_route(n_src: int, n_hub_src: int, same_buffer: bool, dtype: torch.dtype, *, n_rows: int, n_slots: int,
              n_hubs: int, d: int) -> str:
    """The kernel's route for an operator of ``n_rows`` output rows,
    ``n_slots`` ELL slots (an ELL row holds its self term and up to that
    many live slots) and ``n_hubs`` hub rows, over W of ``n_src`` rows of
    ``d`` columns and hub lists over ``n_hub_src`` rows, of W itself
    (``same_buffer``) or of another buffer.  The slab route stages W's rows
    and the other buffer's, 160 bytes a row in either dtype (a strip of 32
    fp32 or 64 bf16 columns and the sector before it), up to
    ``SLAB_MAX_ROWS``.  Where they fit, the rows route still wins, in turns
    on an H100 (PERF.md, row 2y; ``tools/hyb_route_sweep.py``), for

    * at most ``FEW_ROWS`` fp32 output rows (``FEW_ROWS / 2`` bf16 ones, a
      strip holding twice the columns) of at least ``FEW_ROWS_MIN_D``
      columns: a slab block's 128 row groups mostly idle, where the rows
      route's blocks of 8 rows fill the card (circulant-16, whose 16 rows
      are all hub rows of 5 entries).  Narrower, the rows route has too few
      blocks (a shard's 64 rows at d = 256);
    * fp32 W and an operator without hub rows whose ELL rows hold at most
      ``1 + THIN_SLOTS`` entries: the slab route pays for each row's walk
      as much as for its gathers, and the rows route's re-reads of a source
      row come from L2 (ring-1024).

    Else the slab route: it reads W from device memory once, where the rows
    route walks a hub row serially and gathers each source row again for
    every output row that reads it."""
    if dtype not in K.DTYPE_CODES:
        raise TypeError(f"W must be float32 or bfloat16, got {dtype}")
    staged = n_src + (0 if same_buffer else n_hub_src)
    few = 4 * n_rows <= FEW_ROWS * dtype.itemsize and d >= FEW_ROWS_MIN_D
    if staged > SLAB_MAX_ROWS or few or (n_hubs == 0 and dtype == torch.float32 and n_slots <= THIN_SLOTS):
        return "rows"
    return "slab"


def route_of(op: HYB, w: torch.Tensor, w_hub: torch.Tensor | None = None) -> str:
    """``hyb_route`` for the call ``mix_hyb(op, w, w_hub)``."""
    n_hub_src = (w if w_hub is None else w_hub).shape[0] if op.n_hubs else 0
    return hyb_route(w.shape[0], n_hub_src, w_hub is None, w.dtype, n_rows=op.n_rows,
                     n_slots=op.slot_idx.shape[0], n_hubs=op.n_hubs, d=w.shape[1])


def mix_hyb(op: HYB, w: torch.Tensor, w_hub: torch.Tensor | None = None) -> torch.Tensor:
    """Y = M @ W from the HYB form of M: W (n_src, d) node-major params with
    its first ``op.n_rows`` rows the output rows' own, ``w_hub`` (omitted:
    W) the rows the hub lists index; Y (n_rows, d) in W's dtype.  The
    kernel reads no row outside W or ``w_hub``, whatever the tables hold."""
    L.check_w(w)
    n_src, d = w.shape
    n_rows, n_slots, n_hubs = op.n_rows, op.slot_idx.shape[0], op.n_hubs
    if not 0 < n_rows <= n_src:
        raise ValueError(f"{n_rows} output rows over a W of {n_src} rows")
    hub_src = w if w_hub is None else w_hub
    L.check_w(hub_src)
    if hub_src.dtype != w.dtype or hub_src.shape[1] != d or hub_src.device != w.device:
        raise ValueError(f"w_hub must be (*, {d}) {w.dtype} on {w.device}, got {tuple(hub_src.shape)} "
                         f"{hub_src.dtype} on {hub_src.device}")
    nnz = op.hub_col.shape[0]
    shapes = dict(slot_idx=(n_slots, n_rows), slot_w=(n_slots, n_rows), self_w=(n_rows,), hub_rows=(n_hubs,),
                  hub_of=(n_rows,), hub_ptr=(n_hubs + 1,), hub_col=(nnz,), hub_val=(nnz,), walk=(n_rows, 4),
                  entries=(op.entries.shape[0], 2))
    for name, t in op._asdict().items():
        dtype = torch.float32 if name in ("slot_w", "self_w", "hub_val") else torch.int32
        L.check_operand(t, name, dtype, shapes[name], w.device)
    if w.device.type == "cpu":
        return mix_hyb_ref(op, w, w_hub)
    if d == 0:
        return torch.empty((n_rows, d), dtype=w.dtype, device=w.device)
    route = route_of(op, w, w_hub)
    y = _launch(op, w, w_hub, route)
    mix_hyb.launches += 1
    mix_hyb.launches_by_route[route] += 1
    return y


def _launch(op: HYB, w: torch.Tensor, w_hub: torch.Tensor | None, route: str) -> torch.Tensor:
    """One call of ``route`` on checked CUDA tensors with d > 0 (the slab
    route where its rows fit: the C entry refuses more); counts nothing."""
    n_src, d = w.shape
    hub_src = w if w_hub is None else w_hub
    n_rows, n_slots, n_hubs, nnz = op.n_rows, op.slot_idx.shape[0], op.n_hubs, op.hub_col.shape[0]
    y = torch.empty((n_rows, d), dtype=w.dtype, device=w.device)
    vec = min(L.vec_width(w, y), L.vec_width(hub_src, y))
    with torch.cuda.device(w.device):
        if route == "slab":
            n_stage_hub = hub_src.shape[0] if (w_hub is not None and n_hubs) else 0
            err = _lib().mix_hyb_slab(
                K.DTYPE_CODES[w.dtype], K.ptr(op.walk), K.ptr(op.entries), op.entries.shape[0], K.ptr(w),
                K.ptr(hub_src), K.ptr(y), n_src, hub_src.shape[0], n_stage_hub, n_rows, d, vec, K.stream_of(w),
            )
        else:
            tables = (op.slot_idx, op.slot_w, op.self_w, op.hub_of, op.hub_ptr, op.hub_col, op.hub_val)
            err = _lib().mix_hyb(
                K.DTYPE_CODES[w.dtype], *map(K.ptr, tables), K.ptr(w), K.ptr(hub_src), K.ptr(y), n_src,
                hub_src.shape[0], n_rows, d, n_slots, n_hubs, nnz, vec, K.stream_of(w),
            )
    K.raise_on_error(err, f"mix_hyb ({route})")
    return y


mix_hyb.launches = 0
mix_hyb.launches_by_route = dict.fromkeys(ROUTES, 0)
