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
``mix_hyb.launches`` counts kernel launches.  The plain version is the
kernel's arithmetic bit for bit: each ELL row ``self_w·x[i]``, then each
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

__all__ = ["HYB", "hyb_from_tables", "mix_hyb", "mix_hyb_ref"]


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
    column.  Built on the host, once per operator."""
    host = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)  # noqa: E731
    slot_idx, slot_w, self_w = host(slot_idx), host(slot_w), host(self_w)
    hub_rows, hub_m = host(hub_rows).astype(np.int64), host(hub_m).astype(np.float32)
    n_rows = self_w.shape[0]
    hub_of = np.full(n_rows, -1, np.int32)
    hub_of[hub_rows] = np.arange(len(hub_rows), dtype=np.int32)
    hubs, cols = np.nonzero(hub_m)  # row-major: each hub's columns ascending
    hub_ptr = np.searchsorted(hubs, np.arange(len(hub_rows) + 1)).astype(np.int32)
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)  # noqa: E731
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)  # noqa: E731
    return HYB(
        slot_idx=i32(slot_idx.reshape(-1, n_rows)), slot_w=f32(slot_w.reshape(-1, n_rows)), self_w=f32(self_w),
        hub_rows=i32(hub_rows), hub_of=i32(hub_of), hub_ptr=i32(hub_ptr), hub_col=i32(cols),
        hub_val=f32(hub_m[hubs, cols]),
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
    return lib


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
                  hub_of=(n_rows,), hub_ptr=(n_hubs + 1,), hub_col=(nnz,), hub_val=(nnz,))
    for name, t in op._asdict().items():
        dtype = torch.float32 if name in ("slot_w", "self_w", "hub_val") else torch.int32
        L.check_operand(t, name, dtype, shapes[name], w.device)
    if w.device.type == "cpu":
        return mix_hyb_ref(op, w, w_hub)
    y = torch.empty((n_rows, d), dtype=w.dtype, device=w.device)
    if d == 0:
        return y
    vec = min(L.vec_width(w, y), L.vec_width(hub_src, y))
    with torch.cuda.device(w.device):
        err = _lib().mix_hyb(
            K.DTYPE_CODES[w.dtype], K.ptr(op.slot_idx), K.ptr(op.slot_w), K.ptr(op.self_w), K.ptr(op.hub_of),
            K.ptr(op.hub_ptr), K.ptr(op.hub_col), K.ptr(op.hub_val), K.ptr(w), K.ptr(hub_src), K.ptr(y),
            n_src, hub_src.shape[0], n_rows, d, n_slots, n_hubs, nnz, vec, K.stream_of(w),
        )
    K.raise_on_error(err, "mix_hyb")
    mix_hyb.launches += 1
    return y


mix_hyb.launches = 0
