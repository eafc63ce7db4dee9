"""Roofline terms of one step, counted while it runs (counterpart of
``repro/launch/roofline.py``).

Peaks: the H100 SXM's data-sheet figures, not measurements — 989 TFLOP/s
dense bf16 (``PEAK_FLOPS``), 3.35 TB/s HBM3 (``HBM_BW``), and NVLink 4 at
450 GB/s a direction (``LINK_BW``, 900 GB/s both ways a card; ``ICI_BW``
keeps the JAX package's name for it).

Sources.  The JAX package reads a compiled SPMD module's cost analysis
and parses its HLO text for collective operands.  Here ``StepCounter``, a
``TorchDispatchMode``, watches the ops one rank's step issues on its local
shards (DTensor's sharding propagation first turns each DTensor op into
local ops and collectives), and counts:

* FLOPs: ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
  registry: matmuls, convolutions, attention), on local shapes;
* HBM bytes: each op's tensor inputs and outputs, summed.  A pre-fusion
  count: eager PyTorch runs every op as its own kernel, and a fusing
  compiler would move fewer bytes (XLA's figure is post-fusion);
* collective bytes: the operand bytes of every collective, under the JAX
  package's five kind names (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``), from the
  functional collectives DTensor issues and the plain c10d collectives
  (the sharded DecAvg mix's all-gathers, all-to-alls and send / receive
  pairs: a pair is counted once, at its send);
* the peak of live bytes: storages the step makes, added when made and
  taken off when the last tensor on them is freed (views move no bytes
  and make no storage; in-place ops count their operands' bytes).

Only ops on the counted tensors' own fake mode count: DTensor's shape
propagation, which runs ops on global-shape fake tensors of its own, and
its host bookkeeping on small CPU tensors are left out.

Depth.  An eager count sees every layer of the step, so the dry run counts
the full-depth step and calls neither ``extrapolate_depth`` nor
``extrapolate_depth_and_seq``; they stay, with ``_nonneg_poly_extrapolate``,
as this module's API (the JAX dry run needs them because XLA counts a
while body once).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12  # bf16 dense / card, H100 SXM data sheet
HBM_BW = 3.35e12  # bytes/s / card, H100 SXM data sheet
LINK_BW = 450e9  # bytes/s, NVLink 4 one direction, H100 SXM data sheet
ICI_BW = LINK_BW  # the JAX package's name for the link rate

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# op name (overload packet) → collective kind; each entry's first tensor
# argument (or list of tensors) is its operand
_KIND = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.send": "collective-permute",
}
# the operand's position among a c10d op's arguments (output first for most)
_OPERAND_ARG = {
    "c10d.allgather_": 1,
    "c10d._allgather_base_": 1,
    "c10d.allgather_into_tensor_coalesced_": 1,
    "c10d.reduce_scatter_": 1,
    "c10d._reduce_scatter_base_": 1,
    "c10d.alltoall_base_": 1,
    "c10d.alltoall_": 1,
}

__all__ = [
    "HBM_BW",
    "ICI_BW",
    "LINK_BW",
    "PEAK_FLOPS",
    "RooflineTerms",
    "StepCounter",
    "extrapolate_depth",
    "extrapolate_depth_and_seq",
    "model_flops",
    "terms_from_costs",
]


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts FLOPs, HBM bytes, collective operand bytes and the peak of
    live bytes of the local ops run while it is active, on the tensors of
    ``fake_mode`` (a ``FakeTensorMode``; None counts every op on real
    tensors).  Enter it outside the fake mode: DTensor ops pass through
    (``NotImplemented``), so it sees the local ops they become."""

    def __init__(self, fake_mode=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.fake_mode = fake_mode
        self.flops = 0
        self.hbm_bytes = 0
        self.coll = dict.fromkeys(_COLLECTIVES, 0)
        self.n_collectives = dict.fromkeys(_COLLECTIVES, 0)
        self.live = 0
        self.peak = 0
        self._storages: dict[int, list[int]] = {}  # storage → [bytes, tensors seen on it]

    def _ours(self, ts: list[torch.Tensor]) -> bool:
        if self.fake_mode is None:
            return bool(ts)
        return any(getattr(t, "fake_mode", None) is self.fake_mode for t in ts)

    def _track(self, t: torch.Tensor, new: bool) -> None:
        """Count t's storage live while any tensor this counter saw on it
        lives: from the op that made it (``new``) until it and its views
        are gone.  Storages made before the counter (the arguments) are
        not counted."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        if key not in self._storages:
            if not new:
                return
            self._storages[key] = [st.nbytes(), 0]
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        self._storages[key][1] += 1
        weakref.finalize(t, self._drop_ref, key)

    def _drop_ref(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            del self._storages[key]
            self.live -= entry[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors(args) + _tensors(list(kwargs.values())), _tensors(out)
        if not self._ours(ins + outs):
            return out
        name = str(func._overloadpacket)
        kind = _KIND.get(name)
        if kind is not None:
            operand = args[_OPERAND_ARG.get(name, 0)]
            self.coll[kind] += sum(_nbytes(t) for t in _tensors(operand))
            self.n_collectives[kind] += 1
        # outputs that alias an input (views, in-place results) make no
        # storage; a view moves no bytes (the schema says which: inside
        # the dispatch an output is not yet marked as a view)
        aliases = [r.alias_info for r in func._schema.returns]
        fresh = not any(aliases)
        made = outs if fresh else []
        if kind is None and not name.startswith(("_c10d_functional.", "c10d.")) and outs:
            if fresh or any(a is not None and a.is_write for a in aliases):
                self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
            packet = func._overloadpacket
            if packet in self._flop_registry:
                self.flops += self._flop_registry[packet](*args, **kwargs, out_val=out)
        for t in outs:
            self._track(t, any(t is m for m in made))
        return out

    def terms(self) -> "RooflineTerms":
        return terms_from_costs({"flops": self.flops, "bytes accessed": self.hbm_bytes}, dict(self.coll))


@dataclasses.dataclass
class RooflineTerms:
    flops: float  # per-chip
    hbm_bytes: float  # per-chip
    coll_bytes: float  # per-chip
    coll_breakdown: dict[str, int] | None = None

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict[str, Any]:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "collective_breakdown": self.coll_breakdown,
        }


def terms_from_costs(cost: dict, coll_breakdown: dict[str, int]) -> RooflineTerms:
    """Terms from a cost dict (``flops``, ``bytes accessed``) and the
    per-kind collective operand bytes (the JAX call's second argument is
    the HLO text those bytes are parsed from)."""
    cb = {k: int(coll_breakdown.get(k, 0)) for k in _COLLECTIVES}
    return RooflineTerms(
        flops=float(cost.get("flops", 0.0)),
        hbm_bytes=float(cost.get("bytes accessed", 0.0)),
        coll_bytes=float(sum(cb.values())),
        coll_breakdown=cb,
    )


def extrapolate_depth(a: RooflineTerms, b: RooflineTerms, n_periods: int) -> RooflineTerms:
    """total(P) = A + (P-1)·(B-A) from 1-period (A) and 2-period (B) costs."""
    lin = lambda x, y: x + (n_periods - 1) * (y - x)  # noqa: E731
    cb = None
    if a.coll_breakdown is not None and b.coll_breakdown is not None:
        cb = {k: int(lin(a.coll_breakdown[k], b.coll_breakdown[k])) for k in a.coll_breakdown}
    return RooflineTerms(
        flops=lin(a.flops, b.flops),
        hbm_bytes=lin(a.hbm_bytes, b.hbm_bytes),
        coll_bytes=lin(a.coll_bytes, b.coll_bytes),
        coll_breakdown=cb,
    )


def _nonneg_poly_extrapolate(seqs, vals, seq_target: int) -> float:
    """Evaluate a non-negative-coefficient quadratic fit at seq_target.

    Costs are non-negative combinations of {1, S, S²}; projected least
    squares: fit deg-2; if the S² (then S) coefficient is negative, refit
    without it.
    """
    import numpy as np

    seqs = np.asarray(seqs, dtype=np.float64)
    vals = np.asarray(vals, dtype=np.float64)
    for cols in ([seqs**2, seqs, seqs * 0 + 1], [seqs, seqs * 0 + 1], [seqs * 0 + 1]):
        a = np.stack(cols, axis=1)
        coef, *_ = np.linalg.lstsq(a, vals, rcond=None)
        if np.all(coef[:-1] >= 0) or len(cols) == 1:
            basis = {3: [seq_target**2, seq_target, 1.0], 2: [seq_target, 1.0], 1: [1.0]}[len(cols)]
            return float(max(0.0, np.dot(coef, basis)))
    raise AssertionError


def extrapolate_depth_and_seq(
    points: dict[tuple[int, int], RooflineTerms], n_periods: int, seq_target: int
) -> RooflineTerms:
    """Fit cost(P, S) = α(S) + P·β(S) with α, β (constrained) quadratic in S
    from (periods ∈ {1, 2}, seq ∈ {s₁..s_k}) points, k ≥ 3."""
    seqs = sorted({s for (_, s) in points})
    assert len(seqs) >= 3, seqs

    def fit_metric(get) -> float:
        beta_pts = [get(points[(2, s)]) - get(points[(1, s)]) for s in seqs]
        alpha_pts = [get(points[(1, s)]) - b for s, b in zip(seqs, beta_pts)]
        beta = _nonneg_poly_extrapolate(seqs, beta_pts, seq_target)
        alpha = _nonneg_poly_extrapolate(seqs, alpha_pts, seq_target)
        return max(0.0, alpha + n_periods * beta)

    keys = next(iter(points.values())).coll_breakdown.keys()
    cb = {k: int(fit_metric(lambda t, k=k: t.coll_breakdown[k])) for k in keys}
    return RooflineTerms(
        flops=fit_metric(lambda t: t.flops),
        hbm_bytes=fit_metric(lambda t: t.hbm_bytes),
        coll_bytes=float(sum(cb.values())),
        coll_breakdown=cb,
    )


def model_flops(n_active_params: int, tokens: int, kind: str) -> float:
    """Analytic MODEL_FLOPS: 6·N·D for training, 2·N·D forward-only."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens

