"""CommPlan: compile a ``Graph`` into an executable mixing backend
(counterpart of ``repro/core/commplan.py``).

Two backends implement Eq. 2 exactly, both rendered through the port's
hand-written kernels (``repro_torch.kernels.mix``) on the card and through
the kernels' plain versions on the CPU:

``dense``   the (n, n) receive operator, mixed by the dense kernel.
``sparse``  the receive operator in BSR form, mixed by the block-sparse
            kernel.  ``compile_plan`` also precomputes, for every CSR entry
            and every diagonal entry, its slot in the tile array, so a
            masked round writes its renormalised weights into zeroed tiles
            by index assignment and runs the same kernel.

Failure semantics as in the JAX package: one Bernoulli(link_p) draw per
undirected edge (keyed on its index in ``Graph.edge_list()``, so both
directions agree) and one Bernoulli(node_p) per node; the effective
operator renormalises over the surviving neighbourhood, and a dropped
node's row becomes the identity.  Draws come from a CPU ``torch.Generator``
and are copied to the plan's device, so the same generator state gives the
same effective operator on every device.  The ``ppermute`` backend and
``PlanSchedule`` are not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.mix import BSR, bsr_from_dense, bsr_slots, decavg_mix, mix_flat

from .decavg import failure_receive_matrix
from .mixing import receive_matrix
from .topology import Graph

__all__ = ["BACKENDS", "CommPlan", "FailureModel", "block_size", "compile_plan"]

BACKENDS = ("dense", "sparse")


def block_size(n: int) -> int:
    """BSR tile size of the sparse backend: 32 (a 4 KB fp32 tile) from
    n = 256 up, smaller below so a small plan still has several row blocks."""
    return min(32, max(4, (1 << max(n - 1, 0).bit_length()) // 8))


@dataclasses.dataclass(frozen=True)
class FailureModel:
    """Per-round Bernoulli link/node survival probabilities (paper §4.1)."""

    link_p: float = 1.0
    node_p: float = 1.0

    @property
    def active(self) -> bool:
        return self.link_p < 1.0 or self.node_p < 1.0


def _draw_failure_masks(
    failures: FailureModel, n_edges: int, n: int, generator: torch.Generator
) -> tuple[torch.Tensor, torch.Tensor]:
    """(edge_keep (max(n_edges, 1),), node_active (n,)) bool, on the generator's device."""
    width = max(n_edges, 1)
    dev = generator.device
    if failures.link_p < 1.0:
        edge_keep = torch.rand(width, generator=generator, device=dev) < failures.link_p
    else:
        edge_keep = torch.ones(width, dtype=torch.bool, device=dev)
    if failures.node_p < 1.0:
        active = torch.rand(n, generator=generator, device=dev) < failures.node_p
    else:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    return edge_keep, active


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """A compiled plan for one DecAvg round on one device.  ``mix`` is the
    single entry point; ``generator`` is required iff ``failures.active``."""

    graph: Graph
    backend: str
    failures: FailureModel
    data_sizes: np.ndarray | None
    device: torch.device
    n_edges: int
    # ---- dense ----
    receive: torch.Tensor | None = None  # (n, n) static row-stochastic operator
    adjacency: torch.Tensor | None = None  # (n, n) fp32
    edge_uid_matrix: torch.Tensor | None = None  # (n, n) int64 undirected edge ids
    sizes: torch.Tensor | None = None  # (n,) fp32 data sizes
    # ---- sparse (CSR receive order, dst-sorted) ----
    src: torch.Tensor | None = None  # (nnz,) int64
    dst: torch.Tensor | None = None  # (nnz,) int64
    edge_uid: torch.Tensor | None = None  # (nnz,) int64 → undirected edge index
    raw_edge_w: torch.Tensor | None = None  # (nnz,) unnormalised A[dst, src]·s[src]
    raw_self_w: torch.Tensor | None = None  # (n,) unnormalised s
    bsr: BSR | None = None  # the static operator
    edge_slot: torch.Tensor | None = None  # (nnz,) int64 flat slot in bsr.tiles
    self_slot: torch.Tensor | None = None  # (n,) int64 flat slot of each diagonal entry

    @property
    def n(self) -> int:
        return self.graph.n

    def _masked(self, active, edge_live) -> bool:
        """Does this round need the renormalising masked operator?"""
        return self.failures.active or active is not None or edge_live is not None

    def mix(
        self,
        params: torch.Tensor | dict[str, Any],
        generator: torch.Generator | None = None,
        *,
        active: torch.Tensor | None = None,
        edge_live: torch.Tensor | None = None,
    ) -> torch.Tensor | dict[str, Any]:
        """One DecAvg aggregation: ``w_new[i] = Σ_j M[i, j] w[j]``.

        ``params`` is the flat ``(n, d)`` buffer (one kernel launch) or a dict
        of node-stacked tensors.  Returns a new buffer; the input is not
        written.  ``active`` ((n,) bool) and ``edge_live`` ((n_edges,) bool,
        ``Graph.edge_list()`` order) are deterministic membership / fault
        masks AND-composed with the failure draws.
        """
        if self.failures.active and generator is None:
            raise ValueError("failure model active: mix() needs a torch.Generator")
        op = self.round_operator(generator, active=active, edge_live=edge_live)
        if isinstance(params, torch.Tensor):
            return mix_flat(op, params)
        return decavg_mix(op, params)

    def round_operator(
        self, generator: torch.Generator | None = None, *, active=None, edge_live=None
    ) -> torch.Tensor | BSR:
        """This round's operator: the (n, n) matrix or the BSR tiles."""
        if self.backend == "dense":
            return self._dense_round_matrix(generator, active, edge_live)
        return self._sparse_round_bsr(generator, active, edge_live)

    def round_masks(self, generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
        """The per-round failure draws (edge_keep, node_active), on the generator's device."""
        return _draw_failure_masks(self.failures, self.n_edges, self.n, generator)

    def _round_masks_ext(self, generator, active, edge_live) -> tuple[torch.Tensor, torch.Tensor]:
        """Failure draws AND-composed with the deterministic masks, on the
        plan's device.  An ``edge_live`` shorter than the draw pads with True."""
        if self.failures.active:
            edge_keep, node_act = self.round_masks(generator)
        else:
            edge_keep = torch.ones(max(self.n_edges, 1), dtype=torch.bool)
            node_act = torch.ones(self.n, dtype=torch.bool)
        edge_keep, node_act = edge_keep.to(self.device), node_act.to(self.device)
        if edge_live is not None:
            el = torch.as_tensor(edge_live, dtype=torch.bool, device=self.device)
            width = edge_keep.shape[0]
            if el.shape[0] < width:
                el = torch.cat([el, torch.ones(width - el.shape[0], dtype=torch.bool, device=self.device)])
            edge_keep = edge_keep & el[:width]
        if active is not None:
            node_act = node_act & torch.as_tensor(active, dtype=torch.bool, device=self.device)
        return edge_keep, node_act

    def _dense_round_matrix(self, generator, active=None, edge_live=None) -> torch.Tensor:
        if not self._masked(active, edge_live):
            return self.receive
        edge_keep, node_act = self._round_masks_ext(generator, active, edge_live)
        keep = edge_keep[self.edge_uid_matrix] & (self.adjacency > 0)
        keep = keep & node_act[:, None] & node_act[None, :]
        return failure_receive_matrix(self.adjacency * keep, self.sizes)

    def _sparse_round_bsr(self, generator, active=None, edge_live=None) -> BSR:
        if not self._masked(active, edge_live):
            return self.bsr
        edge_keep, node_act = self._round_masks_ext(generator, active, edge_live)
        keep = edge_keep[self.edge_uid] & node_act[self.src] & node_act[self.dst]
        # every slot is written once (plain index assignment, nothing
        # accumulates), then each row is divided by its own sum: the
        # surviving raw weights plus the self weight, i.e. the
        # renormalisation of commplan.py:493-504, reduced in a fixed order
        tiles = self.bsr.tiles
        flat = torch.zeros(tiles.numel(), dtype=torch.float32, device=self.device)
        flat[self.edge_slot] = self.raw_edge_w * keep
        flat[self.self_slot] = self.raw_self_w
        flat = flat.view(tiles.shape)
        den = flat.sum(dim=(1, 3), keepdim=True)
        return self.bsr._replace(tiles=flat / torch.where(den > 0, den, torch.ones_like(den)))

    def with_options(
        self,
        *,
        backend: str | None = None,
        data_sizes: np.ndarray | None = None,
        failures: FailureModel | None = None,
    ) -> "CommPlan":
        """Recompile this plan with some knobs replaced."""
        return compile_plan(
            self.graph,
            backend=backend or self.backend,
            data_sizes=self.data_sizes if data_sizes is None else data_sizes,
            failures=failures or self.failures,
            device=self.device,
        )


def compile_plan(
    graph: Graph,
    backend: str = "auto",
    data_sizes: np.ndarray | Sequence[float] | None = None,
    failures: FailureModel | None = None,
    device: str | torch.device | None = None,
) -> CommPlan:
    """Lower a ``Graph`` into a ``CommPlan`` on ``device`` (default cuda).

    backend="auto" picks dense for n ≤ 64 and sparse beyond, as the JAX
    package does.  The sparse backend's tile size is ``block_size(n)``.
    """
    dev = resolve_device(device)
    failures = failures or FailureModel()
    if backend == "auto":
        backend = "dense" if graph.n <= 64 else "sparse"
    if backend == "ppermute":
        raise NotImplementedError(
            "the ppermute (edge-coloured) backend is not ported yet; see ROADMAP.md Queue 1"
        )
    if backend not in BACKENDS:
        raise ValueError(f"unknown mixing backend {backend!r}; expected one of {BACKENDS}")

    sizes = None if data_sizes is None else np.asarray(data_sizes, dtype=np.float64)
    n = graph.n
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    i64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)  # noqa: E731
    common = dict(
        graph=graph,
        backend=backend,
        failures=failures,
        data_sizes=None if sizes is None else sizes.copy(),
        device=dev,
        n_edges=len(graph.edge_list()),
    )

    if backend == "dense":
        uid_matrix = np.zeros((n, n), dtype=np.int64)
        edges = graph.edge_list()
        uid_matrix[edges[:, 0], edges[:, 1]] = np.arange(len(edges))
        if not graph.directed:
            uid_matrix[edges[:, 1], edges[:, 0]] = np.arange(len(edges))
        return CommPlan(
            **common,
            receive=f32(receive_matrix(graph, sizes)),
            adjacency=f32(graph.adjacency),
            edge_uid_matrix=i64(uid_matrix),
            sizes=None if sizes is None else f32(sizes),
        )

    s = np.ones(n, dtype=np.float64) if sizes is None else sizes
    block_n = block_size(n)
    indptr, src, uid = graph.csr()
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    raw_edge = graph.adjacency[dst, src].astype(np.float64) * s[src]
    den = s + np.bincount(dst, weights=raw_edge, minlength=n)
    # block structure of the receive pattern A + I (values do not matter)
    pattern = (graph.adjacency != 0).astype(np.float32) + np.eye(n, dtype=np.float32)
    block_cols, _, counts = bsr_from_dense(pattern, block_n)
    nrb, max_nnz = block_cols.shape
    edge_slot = bsr_slots(block_cols, counts, dst, src, block_n)
    self_slot = bsr_slots(block_cols, counts, np.arange(n), np.arange(n), block_n)
    tiles = np.zeros(nrb * max_nnz * block_n * block_n, dtype=np.float32)
    tiles[edge_slot] = raw_edge / den[dst]
    tiles[self_slot] = s / den
    bsr = BSR(
        block_cols=torch.as_tensor(block_cols, device=dev),
        tiles=f32(tiles.reshape(nrb, max_nnz, block_n, block_n)),
        counts=torch.as_tensor(counts, device=dev),
    )
    return CommPlan(
        **common,
        src=i64(src),
        dst=i64(dst),
        edge_uid=i64(uid),
        raw_edge_w=f32(raw_edge),
        raw_self_w=f32(s),
        bsr=bsr,
        edge_slot=i64(edge_slot),
        self_slot=i64(self_slot),
    )
