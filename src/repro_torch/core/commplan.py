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

``spread`` applies the transpose Mᵀ (column-stochastic, mass-conserving:
the send form push-sum gossip needs, ``repro_torch.gossip``) through the
same kernels: a plan builds Mᵀ at its first send-form round and keeps it
(a plan that only trains never pays for it), dense or as a BSR of its own
with the slots of every edge at (src, dst) and of the diagonal, and a
masked round copies M's renormalised weights into those slots, each slot
once.
``spread_min`` is the neighbourhood min-exchange of the leaderless size
sketches, in plain torch.  Both take the same draws and masks as ``mix``.

Failure semantics as in the JAX package: one Bernoulli(link_p) draw per
undirected edge (keyed on its index in ``Graph.edge_list()``, so both
directions agree) and one Bernoulli(node_p) per node; the effective
operator renormalises over the surviving neighbourhood, and a dropped
node's row becomes the identity.  Draws come from a CPU ``torch.Generator``
and are copied to the plan's device, so the same generator state gives the
same effective operator on every device.  With an active ``compression``
codec a round is the error-feedback delta form of ``core/compress.py``
over the same operator (int8 / fp8 through the quantised-mix kernel).

``ppermute``  the greedy edge colouring (``Graph.edge_coloring``): each
            colour class is a matching, one ``ppermute`` round in the JAX
            package's ``shard_map``.  On one device both packages render it
            as node-axis gathers, one a colour (``decavg.mix_pytree_colored``,
            plain torch on every device: the JAX package has no kernel for
            it either); its compressed rounds take the plain codec.  Over a
            process group, one node a rank (``CommPlan.shard``), each colour
            is one exchange (``core/shardplan.py``).

``CommPlan.shard`` renders a plan over a node-sharded process group
(``core/shardplan.py``, DESIGN.md §15).

Event-driven (asynchronous) rendering, undirected plans on every backend:
``event_uv`` / ``event_w`` hold each edge's endpoints and its weights
``(M[u, v], M[v, u])`` in ``Graph.edge_list()`` order (data sizes
included).  ``event_mix`` / ``event_spread`` / ``event_spread_min`` move an
edge's two endpoints (``decavg``'s pairwise forms); edge -1, the stream's
padding, and a failed draw are the exact identity.  ``event_mix_batch``
applies a matching of events at once.  An event's failure draw is one
Bernoulli(link_p) for its edge and one Bernoulli(node_p) per endpoint
(``draw_event_flags``): where the JAX package keys event i by threefry's
``fold_in(key, i)``, the port reads row i of a float32 uniform table drawn
from ``numpy.random.default_rng(seed)``, so an event's flag depends on
(seed, i) alone, whatever the envelope or the order of calls.
``event_flags`` is the one place the executors and the gossip engine take
a stream's flags from.

``PlanSchedule`` (``compile_schedule``) is a time-varying operator: K
compiled plans and a round → plan map (``cyclic_map``, ``sequence_map``).
The port's executors loop on the host, so ``select(r)`` is the active
``CommPlan`` itself and each round runs that plan's kernels.  Every plan of
a schedule draws its failures at the schedule's edge envelope
(``n_edges_env``, the largest plan's edge count), so the generator moves
the same amount whichever plan is active.  Its event operators run an event
under the plan active in the event's unit-time window, and
``event_stream`` draws each window's events from that window's plan.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.flat import FlatLayout, tree_map
from repro_torch.kernels.mix import BSR, bsr_from_dense, bsr_slots, decavg_mix, mix_flat

from .compress import Compression, compressed_mix, compressed_spread, init_residuals
from .decavg import (
    failure_receive_matrix,
    mix_pytree_colored,
    mix_pytree_pairwise,
    mix_pytree_pairwise_batch,
    spread_min_pairwise,
    spread_pairwise,
)
from .mixing import receive_matrix
from .topology import EventStream, Graph, poisson_event_stream

__all__ = [
    "BACKENDS",
    "CommPlan",
    "FailureModel",
    "PlanSchedule",
    "RoundMap",
    "block_size",
    "compile_plan",
    "compile_schedule",
    "cyclic_map",
    "draw_event_flags",
    "event_flags",
    "sequence_map",
]

BACKENDS = ("dense", "sparse", "ppermute")


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


def draw_event_flags(failures: FailureModel, seed: int, count: int) -> np.ndarray | None:
    """(count,) bool: did event i's exchange survive the failure model?
    None when the model draws nothing.  Event i reads row i of a (count, 3)
    float32 uniform table from ``numpy.random.default_rng(seed)``: its
    edge's link uniform and its two endpoints' node uniforms.  The table is
    drawn in row order, so a longer ``count`` leaves the first rows as
    they were."""
    if not failures.active:
        return None
    if seed is None:
        raise ValueError("failure model active: event draws need a seed")
    uni = np.random.default_rng(int(seed)).random((int(count), 3), dtype=np.float32)
    keep = np.ones(int(count), dtype=bool)
    if failures.link_p < 1.0:
        keep &= uni[:, 0] < failures.link_p
    if failures.node_p < 1.0:
        keep &= (uni[:, 1] < failures.node_p) & (uni[:, 2] < failures.node_p)
    return keep


def event_flags(plan, seed: int | None, stream: EventStream) -> np.ndarray | None:
    """The failure draws of a stream's events, (envelope,) bool, or None
    when ``plan`` (a ``CommPlan`` or ``PlanSchedule``) draws none.  Event i
    keys on (``seed``, i); over a K > 1 schedule on (``event_key(seed,
    times[i])``, i), the seed of the plan active in its window."""
    if not plan.failures.active:
        return None
    env = stream.envelope
    if isinstance(plan, CommPlan) or plan.k == 1:
        return draw_event_flags(plan.failures, seed, env)
    if seed is None:
        raise ValueError("failure model active: event draws need a seed")
    seeds = np.array([plan.event_key(seed, t) for t in stream.times], dtype=np.uint64)
    out = np.zeros(env, dtype=bool)
    for s in np.unique(seeds):
        at = seeds == s
        out[at] = draw_event_flags(plan.failures, int(s), env)[at]
    return out


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
    # ---- ppermute (edge-coloured) ----
    partners: np.ndarray | None = None  # (n_colors, n) int32 per-colour matchings
    color_edge_uid: torch.Tensor | None = None  # (n_colors, n) int64, -1 unmatched
    color_w: torch.Tensor | None = None  # (n_colors, n) statically normalised
    color_raw_w: torch.Tensor | None = None  # (n_colors, n) unnormalised A[i, p]·s[p]
    self_w: torch.Tensor | None = None  # (n,) statically normalised self weight
    # ---- event-driven (asynchronous) rendering, undirected plans only ----
    event_uv: torch.Tensor | None = None  # (max(n_edges, 1), 2) int64 endpoints
    event_w: torch.Tensor | None = None  # (max(n_edges, 1), 2) fp32 [M[u, v], M[v, u]]
    # failure-draw width: a schedule's edge envelope (compile_schedule); 0 is n_edges
    n_edges_draw: int = 0

    @property
    def n(self) -> int:
        return self.graph.n

    @property
    def n_colors(self) -> int:
        return 0 if self.partners is None else self.partners.shape[0]

    @property
    def draw_width(self) -> int:
        """Edges a failure draw covers: ``n_edges``, or the envelope of the
        schedule the plan belongs to."""
        return max(self.n_edges_draw, self.n_edges)

    @functools.cached_property
    def _partners_dev(self) -> torch.Tensor:
        """The colour table on the plan's device, int64, copied once."""
        return torch.as_tensor(self.partners, dtype=torch.int64, device=self.device)

    @functools.cached_property
    def _clean(self) -> "CommPlan":
        """This plan without its failure model, its tensors shared, made once:
        the gossip rounds take their draws as masks and run on it, so its Mᵀ
        (``_send``) is built once however many phases run."""
        if not self.failures.active:
            return self
        return dataclasses.replace(self, failures=FailureModel())

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
        compression: Compression | None = None,
        residual: torch.Tensor | dict[str, Any] | None = None,
        layout: FlatLayout | None = None,
    ):
        """One DecAvg aggregation: ``w_new[i] = Σ_j M[i, j] w[j]``.

        ``params`` is the flat ``(n, d)`` buffer (one kernel launch) or a dict
        of node-stacked tensors.  Returns a new buffer; the input is not
        written.  ``active`` ((n,) bool) and ``edge_live`` ((n_edges,) bool,
        ``Graph.edge_list()`` order) are deterministic membership / fault
        masks AND-composed with the failure draws.

        With an active ``compression`` codec the round runs the
        error-feedback delta form over this same operator and returns
        ``(mixed, new_residual)``: thread ``residual`` (the fp32 mirrors,
        shaped as ``params``) from the previous round; omitted, it is zeros.
        ``layout`` names the leaves of a flat buffer, which the codec chunks
        one by one (None: the row is one leaf).  Codec ``"none"`` or
        ``compression=None`` is the raw operator, bit for bit.
        """
        if self.failures.active and generator is None:
            raise ValueError("failure model active: mix() needs a torch.Generator")
        if compression is not None and compression.active:
            return compressed_mix(
                self, params, init_residuals(params) if residual is None else residual, generator,
                compression=compression, active=active, edge_live=edge_live, layout=layout,
            )
        if self.backend == "ppermute":
            color_w, self_w = self.color_round_weights(generator, active=active, edge_live=edge_live)
            return mix_pytree_colored(params, self._partners_dev, color_w, self_w)
        op = self.round_operator(generator, active=active, edge_live=edge_live)
        if isinstance(params, torch.Tensor):
            return mix_flat(op, params)
        return decavg_mix(op, params)

    def spread(
        self,
        values: torch.Tensor,
        generator: torch.Generator | None = None,
        *,
        active: torch.Tensor | None = None,
        edge_live: torch.Tensor | None = None,
        compression: Compression | None = None,
        residual: torch.Tensor | None = None,
    ):
        """One send-form (column-stochastic) round: ``values ← Mᵀ values``,
        one launch of the mixing kernel over Mᵀ.

        ``values`` is an (n,) or (n, k) payload; the result has its shape,
        fp32.  The masked M keeps every row summing to 1, so Mᵀ conserves
        ``values.sum(0)`` under any draw or mask.  ``generator``, ``active``
        and ``edge_live`` are ``mix``'s: for the same arguments the round
        rides the same links.  With an active ``compression`` codec the
        round is the delta form ``v + γ (Mᵀ h' − h')`` of
        ``core/compress.py::compressed_spread`` and returns ``(values,
        residual)``, mass-conserving for any codec.
        """
        if self.failures.active and generator is None:
            raise ValueError("failure model active: spread() needs a torch.Generator")
        if compression is not None and compression.active:
            return compressed_spread(
                self, values, residual, generator, compression=compression, active=active, edge_live=edge_live,
            )
        x = torch.as_tensor(values, dtype=torch.float32, device=self.device)
        if self.backend == "ppermute":
            # node j receives what its colour-c partner sent: each colour is
            # an involution, so gathering the sends at partners[c] lands an
            # edge's mass on its other endpoint
            color_w, self_w = self.color_round_weights(generator, active=active, edge_live=edge_live)
            x2 = x.reshape(self.n, -1)
            sends = color_w[:, :, None] * x2[None, :, :]
            recv = sends[torch.arange(self.n_colors, device=self.device)[:, None], self._partners_dev]
            return (self_w[:, None] * x2 + recv.sum(dim=0)).reshape(x.shape)
        op = self.send_operator(generator, active=active, edge_live=edge_live)
        out = mix_flat(op, x.reshape(self.n, -1).contiguous())
        return out.reshape(x.shape)

    def spread_min(
        self,
        values: torch.Tensor,
        generator: torch.Generator | None = None,
        *,
        active: torch.Tensor | None = None,
        edge_live: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """One round of neighbourhood min-exchange over the live links:
        ``out[i] = min(values[i], min over i's surviving neighbours)``, the
        transport of the leaderless size sketches, with ``mix``'s draws and
        masks.  Plain torch (the JAX package has no kernel for it): dense
        plans take a masked ``amin`` over each row, sparse ones gather each
        edge's source value and reduce per destination with
        ``scatter_reduce("amin")``; a min is exact, so the order of the
        reduction cannot change a bit.  (n,) or (n, k) in, the same out."""
        if self.failures.active and generator is None:
            raise ValueError("failure model active: spread_min() needs a torch.Generator")
        x = torch.as_tensor(values, dtype=torch.float32, device=self.device)
        x2 = x.reshape(self.n, -1)
        masked = self._masked(active, edge_live)
        if masked:
            edge_keep, node_act = self._round_masks_ext(generator, active, edge_live)
        inf = torch.tensor(float("inf"), device=self.device)
        if self.backend == "dense":
            keep = self.adjacency > 0
            if masked:
                keep = keep & edge_keep[self.edge_uid_matrix] & node_act[:, None] & node_act[None, :]
            nbr = torch.where(keep[:, :, None], x2[None, :, :], inf).amin(dim=1)
        elif self.backend == "ppermute":
            partners = self._partners_dev
            keep = self.color_edge_uid >= 0
            if masked:
                keep = keep & edge_keep[self.color_edge_uid.clamp_min(0)]
                keep = keep & node_act[None, :] & node_act[partners]
            cand = torch.where(keep[:, :, None], x2[partners], inf)
            nbr = cand.amin(dim=0) if self.n_colors else torch.full_like(x2, float("inf"))
        else:
            gathered = x2[self.src]
            if masked:
                keep = edge_keep[self.edge_uid] & node_act[self.src] & node_act[self.dst]
                gathered = torch.where(keep[:, None], gathered, inf)
            index = self.dst[:, None].expand_as(gathered)
            nbr = torch.full_like(x2, float("inf")).scatter_reduce_(0, index, gathered, "amin")
        return torch.minimum(x2, nbr).reshape(x.shape)

    @functools.cached_property
    def _send(self) -> tuple:
        """The static Mᵀ, built at the first send-form round: dense, the
        contiguous transpose; sparse, (BSR of Mᵀ, slot of each edge's weight
        at (src, dst) in its tiles, slot of each diagonal entry).  An
        undirected graph's pattern is symmetric, so Mᵀ keeps M's block
        structure and only its tiles and slots are new."""
        if self.backend == "dense":
            return (self.receive.T.contiguous(),)
        bn = self.bsr.tiles.shape[-1]
        if self.graph.directed:
            pattern = (self.graph.adjacency != 0).astype(np.float32) + np.eye(self.n, dtype=np.float32)
            block_cols, _, counts = bsr_from_dense(pattern.T, bn)
        else:
            block_cols, counts = self.bsr.block_cols.cpu().numpy(), self.bsr.counts.cpu().numpy()
        src, dst, diag = self.src.cpu().numpy(), self.dst.cpu().numpy(), np.arange(self.n)
        edge_slot_t = torch.as_tensor(bsr_slots(block_cols, counts, src, dst, bn), device=self.device)
        self_slot_t = torch.as_tensor(bsr_slots(block_cols, counts, diag, diag, bn), device=self.device)
        static = BSR(
            block_cols=torch.as_tensor(block_cols, device=self.device),
            tiles=torch.zeros(*block_cols.shape, bn, bn, dtype=torch.float32, device=self.device),
            counts=torch.as_tensor(counts, device=self.device),
        )
        return self._transpose_tiles(self.bsr, static, edge_slot_t, self_slot_t), edge_slot_t, self_slot_t

    def _transpose_tiles(self, m: BSR, like: BSR, edge_slot_t, self_slot_t) -> BSR:
        """M's tiles copied into zeroed Mᵀ tiles: each edge's and each self
        weight into its slot, plain index assignment, every slot once."""
        m_flat = m.tiles.reshape(-1)
        flat = torch.zeros(like.tiles.numel(), dtype=torch.float32, device=self.device)
        flat[edge_slot_t] = m_flat[self.edge_slot]
        flat[self_slot_t] = m_flat[self.self_slot]
        return like._replace(tiles=flat.view(like.tiles.shape))

    def send_operator(
        self, generator: torch.Generator | None = None, *, active=None, edge_live=None
    ) -> torch.Tensor | BSR:
        """This round's Mᵀ: the (n, n) matrix or the BSR tiles.  A masked
        sparse round renormalises M's tiles (``round_operator``), then
        copies them into Mᵀ's slots (``_transpose_tiles``)."""
        if self.backend == "ppermute":
            raise ValueError("a ppermute plan holds no operator matrix: use color_round_weights")
        if not self._masked(active, edge_live):
            return self._send[0]
        m = self.round_operator(generator, active=active, edge_live=edge_live)
        if self.backend == "dense":
            return m.T.contiguous()
        return self._transpose_tiles(m, *self._send)

    def round_operator(
        self, generator: torch.Generator | None = None, *, active=None, edge_live=None
    ) -> torch.Tensor | BSR:
        """This round's operator: the (n, n) matrix or the BSR tiles."""
        if self.backend == "ppermute":
            raise ValueError("a ppermute plan holds no operator matrix: use color_round_weights")
        if self.backend == "dense":
            return self._dense_round_matrix(generator, active, edge_live)
        return self._sparse_round_bsr(generator, active, edge_live)

    def round_masks(self, generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
        """The per-round failure draws (edge_keep (draw_width,), node_active
        (n,)), on the generator's device."""
        return _draw_failure_masks(self.failures, self.draw_width, self.n, generator)

    def color_round_weights(
        self, generator: torch.Generator | None = None, *, active=None, edge_live=None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """((n_colors, n), (n,)) normalised weights of this round's colour
        schedule: the static ones, or the surviving raw weights over each
        node's own sum when the round is masked."""
        if not self._masked(active, edge_live):
            return self.color_w, self.self_w
        edge_keep, node_act = self._round_masks_ext(generator, active, edge_live)
        keep = self.color_edge_uid >= 0
        keep = keep & edge_keep[self.color_edge_uid.clamp_min(0)]
        keep = keep & node_act[None, :] & node_act[self._partners_dev]
        num = self.color_raw_w * keep
        den = self.raw_self_w + num.sum(dim=0)
        return num / den[None, :], self.raw_self_w / den

    def color_perms(self) -> list[list[tuple[int, int]]]:
        """The (src, dst) pairs of each colour class: one ppermute each."""
        return [[(i, int(p[i])) for i in range(self.n) if p[i] != i] for p in self.partners]

    def wire_messages(
        self, generator: torch.Generator | None = None, *, active=None, edge_live=None
    ) -> torch.Tensor | int:
        """Messages one round delivers: two per live undirected edge (both
        endpoints active), counted by the one accountant,
        ``obs.wirecost.make_wire_fn``.  Under an active failure model
        ``generator`` must be in the state the round's mix drew its masks
        from (a copy taken before the round): the count replays those draws.
        ``active`` / ``edge_live`` are ``mix``'s deterministic masks,
        AND-composed with the draws the same way.  A device scalar when
        anything is masked, else an int."""
        from repro_torch.obs.wirecost import make_wire_fn

        if self.failures.active and generator is None:
            raise ValueError("failure model active: wire_messages() needs the round's torch.Generator")
        wire = make_wire_fn(self)
        if wire is None:
            raise ValueError("a directed plan has no wire count (no event tables)")
        return wire(generator, active=active, edge_live=edge_live)

    def _round_masks_ext(self, generator, active, edge_live) -> tuple[torch.Tensor, torch.Tensor]:
        """Failure draws AND-composed with the deterministic masks, on the
        plan's device.  An ``edge_live`` shorter than the draw pads with True."""
        if self.failures.active:
            edge_keep, node_act = self.round_masks(generator)
        else:
            edge_keep = torch.ones(max(self.draw_width, 1), dtype=torch.bool)
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

    # ------------------------------------------------- event-driven execution
    @functools.cached_property
    def _event_uv_host(self) -> np.ndarray:
        """The endpoint table on the host, copied once: events are resolved
        there, so no event reads the device."""
        return self.event_uv.cpu().numpy()

    @functools.cached_property
    def event_m2(self) -> torch.Tensor:
        """(max(n_edges, 1), 2, 2) fp32: each edge's exchange as a 2 × 2
        operator ``[[1 − w_uv, w_uv], [w_vu, 1 − w_vu]]`` on the device, the
        quantised pair round's M, made once."""
        w = self.event_w
        one = torch.ones_like(w[:, 0])
        return torch.stack([torch.stack([one - w[:, 0], w[:, 0]], 1), torch.stack([w[:, 1], one - w[:, 1]], 1)], 1)

    def _event_edge(self, edge, keep):
        """(u, v, w) of one event, ``w`` the (2,) device weights; None for
        the identity: padding (edge −1) or a failed draw."""
        if self.event_uv is None:
            raise ValueError("event rendering needs an undirected CommPlan (directed plans have no event tables)")
        if self.failures.active and keep is None:
            raise ValueError("failure model active: event ops need the event's keep flag (event_flags)")
        e = int(edge)
        if e < 0 or (self.failures.active and not keep):
            return None
        if e >= self.n_edges:
            raise IndexError(f"edge {e} outside the plan's {self.n_edges} edges")
        u, v = self._event_uv_host[e]
        return int(u), int(v), self.event_w[e]

    def event_mix(self, params, edge, keep: bool | None = None):
        """One asynchronous DecAvg event: edge ``edge``'s endpoints blend
        with the plan's receive weights (``w_u ← w_u + M[u,v]·(w_v − w_u)``
        and symmetrically), everyone else untouched.  ``edge`` indexes
        ``Graph.edge_list()``; ``keep`` is the event's failure draw, needed
        iff the failure model is active.  A flat (n, d) buffer or a dict
        tree; returns a new one.  Composing one event per edge reproduces
        ``mix`` to first order in the weights."""
        ev = self._event_edge(edge, keep)
        if ev is None:
            return tree_map(torch.clone, params)
        u, v, w = ev
        return mix_pytree_pairwise(params, u, v, w[0], w[1])

    def event_mix_batch(self, params, edges, keeps=None):
        """One colour step: a batch of events on endpoint-disjoint edges
        (``topology.batch_events_by_color``), each endpoint row gathered and
        written once.  ``edges`` (W,) host ints, -1 padding; ``keeps`` (W,)
        the events' failure draws, needed iff the model is active.  Padding
        and failed draws are dropped on the host; bitwise the sequential
        ``event_mix`` calls."""
        if self.event_uv is None:
            raise ValueError("event rendering needs an undirected CommPlan (directed plans have no event tables)")
        if self.failures.active and keeps is None:
            raise ValueError("failure model active: event_mix_batch needs the events' keep flags")
        e = np.asarray(edges, dtype=np.int64).reshape(-1)
        live = e >= 0
        if self.failures.active:
            live &= np.asarray(keeps, dtype=bool).reshape(-1)
        e = e[live]
        uv = self._event_uv_host[e]
        idx = torch.as_tensor(e, device=self.device)
        w = self.event_w[idx]
        return mix_pytree_pairwise_batch(params, uv[:, 0], uv[:, 1], w[:, 0], w[:, 1])

    def event_spread(self, values, edge, keep: bool | None = None) -> torch.Tensor:
        """One asynchronous push event (``s_u ← s_u − M[u,v]·s_u +
        M[v,u]·s_v`` and symmetrically): ``values.sum(0)`` is kept event by
        event, which barrier-free push-sum rides.  (n,) or (n, k); fp32."""
        x = torch.as_tensor(values, dtype=torch.float32, device=self.device)
        ev = self._event_edge(edge, keep)
        if ev is None:
            return x.clone()
        u, v, w = ev
        return spread_pairwise(x, u, v, w[0], w[1])

    def event_spread_min(self, values, edge, keep: bool | None = None) -> torch.Tensor:
        """One asynchronous min event: both endpoints take the coordinate-wise
        minimum over the live exchange (the leaderless sketches' transport)."""
        x = torch.as_tensor(values, dtype=torch.float32, device=self.device)
        ev = self._event_edge(edge, keep)
        if ev is None:
            return x.clone()
        return spread_min_pairwise(x, ev[0], ev[1])

    def shard(self, *, group=None, n_shards: int | None = None):
        """Render this plan over a node-sharded process group (DESIGN.md
        §15): see ``core.shardplan.shard_plan`` for the partition contract."""
        from .shardplan import shard_plan  # shardplan builds on CommPlan

        return shard_plan(self, group=group, n_shards=n_shards)

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
    ``ppermute`` compiles the greedy edge colouring (undirected graphs only).
    """
    dev = resolve_device(device)
    failures = failures or FailureModel()
    if backend == "auto":
        backend = "dense" if graph.n <= 64 else "sparse"
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
        **_event_tables(graph, sizes, dev),
    )

    if backend == "dense":
        uid_matrix = np.zeros((n, n), dtype=np.int64)
        edges = graph.edge_list()
        uid_matrix[edges[:, 0], edges[:, 1]] = np.arange(len(edges))
        if not graph.directed:
            uid_matrix[edges[:, 1], edges[:, 0]] = np.arange(len(edges))
        receive = receive_matrix(graph, sizes)
        return CommPlan(
            **common,
            receive=f32(receive),
            adjacency=f32(graph.adjacency),
            edge_uid_matrix=i64(uid_matrix),
            sizes=None if sizes is None else f32(sizes),
        )

    s = np.ones(n, dtype=np.float64) if sizes is None else sizes
    if backend == "ppermute":
        coloring = graph.edge_coloring()
        partners = coloring.partners
        idx = np.arange(n)
        matched = partners != idx[None, :]
        # receive weight of edge (i, partner) at node i: A[i, partner]·s[partner]
        raw = np.where(matched, graph.adjacency[idx[None, :], partners] * s[partners], 0.0)
        den = s + raw.sum(axis=0)
        return CommPlan(
            **common,
            partners=partners,
            color_edge_uid=i64(coloring.edge_index),
            color_w=f32(raw / den[None, :]),
            color_raw_w=f32(raw),
            self_w=f32(s / den),
            raw_self_w=f32(s),
        )
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


def _event_tables(graph: Graph, sizes: np.ndarray | None, dev: torch.device) -> dict:
    """``event_uv[e] = (u, v)`` in ``Graph.edge_list()`` order and
    ``event_w[e] = (M[u, v], M[v, u])``, the receive operator's entries, so
    one event an edge composes to one synchronous round to first order.
    At least one row (zeros on an edgeless graph); none for a directed
    graph, whose exchanges have no pairwise form."""
    if graph.directed:
        return {}
    edges = graph.edge_list()
    if len(edges) == 0:
        return dict(event_uv=torch.zeros((1, 2), dtype=torch.int64, device=dev),
                    event_w=torch.zeros((1, 2), dtype=torch.float32, device=dev))
    m = receive_matrix(graph, sizes)
    u, v = edges[:, 0], edges[:, 1]
    return dict(
        event_uv=torch.as_tensor(edges.astype(np.int64), device=dev),
        event_w=torch.as_tensor(np.stack([m[u, v], m[v, u]], axis=1), dtype=torch.float32, device=dev),
    )


# ---------------------------------------------------------------- schedules
@dataclasses.dataclass(frozen=True)
class RoundMap:
    """Round index → plan index of a ``PlanSchedule``.

    ``cyclic``:   plan ``(r // period) % K``, the plans taking turns,
                  ``period`` rounds each.
    ``sequence``: plan ``sequence[r % len(sequence)]``, an explicit
                  assignment tiled past its horizon.
    """

    kind: str  # "cyclic" | "sequence"
    period: int = 1
    sequence: np.ndarray | None = None

    def __post_init__(self):
        if self.kind not in ("cyclic", "sequence"):
            raise ValueError(f"unknown round-map kind {self.kind!r}")
        if self.kind == "cyclic" and self.period < 1:
            raise ValueError("cyclic round map needs period >= 1")
        if self.kind == "sequence" and (self.sequence is None or len(self.sequence) == 0):
            raise ValueError("sequence round map needs a non-empty index sequence")


def cyclic_map(period: int = 1) -> RoundMap:
    """Plans take turns, ``period`` consecutive rounds each."""
    return RoundMap("cyclic", period=int(period))


def sequence_map(sequence) -> RoundMap:
    """Explicit per-round plan indices, tiled past the horizon."""
    return RoundMap("sequence", sequence=np.asarray(sequence, np.int32))


@dataclasses.dataclass(frozen=True)
class PlanSchedule:
    """A time-varying mixing operator: K compiled ``CommPlan``s and a round map.

    The plans share one backend, one failure model, the data sizes and the
    node count.  ``select(r)`` is the plan active at round r, the compiled
    object itself, so its kernels, operators and its lazily built Mᵀ serve
    every round it is active.  Every plan draws its failures at the edge
    envelope ``n_edges_env``, so a generator advances the same amount
    whichever plan is active and ``round_masks`` replays any round's draw;
    ``edge_live`` masks are read at that width too, indexed by the active
    plan's own edge ids.  K = 1 is the static plan, bit for bit.  The JAX
    package folds the plan index into a round's failure key (threefry's
    ``fold_in``, which torch cannot replay); here each round simply draws
    from the generator it is given.  An event runs under the plan active in
    its unit-time window (``floor(time)``, one window a round of the round
    map), its failure draw keyed on ``event_key(seed, time)``.
    """

    plans: tuple[CommPlan, ...]
    round_map: RoundMap
    n_edges_env: int = 0

    @property
    def k(self) -> int:
        return len(self.plans)

    @property
    def n(self) -> int:
        return self.plans[0].n

    @property
    def backend(self) -> str:
        return self.plans[0].backend

    @property
    def failures(self) -> FailureModel:
        return self.plans[0].failures

    @property
    def data_sizes(self) -> np.ndarray | None:
        return self.plans[0].data_sizes

    @property
    def device(self) -> torch.device:
        return self.plans[0].device

    @property
    def graph(self) -> Graph:
        """The round-0 plan's graph: the size and degrees a node sees at the
        start (estimation payloads, the walker's start checks)."""
        return self.plans[0].graph

    def plan_index(self, round_index) -> int:
        """The index of the plan active at ``round_index`` (a host int)."""
        if self.k == 1:
            return 0
        r, m = int(round_index), self.round_map
        if m.kind == "cyclic":
            return (r // m.period) % self.k
        return int(m.sequence[r % len(m.sequence)])

    def select(self, round_index) -> CommPlan:
        """The ``CommPlan`` active at ``round_index``: K = 1, the plan itself."""
        return self.plans[self.plan_index(round_index)]

    def mix(self, params, round_index, generator: torch.Generator | None = None, **kwargs):
        """``CommPlan.mix`` of the plan active at ``round_index`` (the same
        keywords: ``active``, ``edge_live``, ``compression``, ``residual``,
        ``layout``)."""
        return self.select(round_index).mix(params, generator, **kwargs)

    def spread(self, values, round_index, generator: torch.Generator | None = None, **kwargs):
        """One send-form (push) round under the active plan."""
        return self.select(round_index).spread(values, generator, **kwargs)

    def spread_min(self, values, round_index, generator: torch.Generator | None = None, **kwargs):
        """One min-exchange round under the active plan."""
        return self.select(round_index).spread_min(values, generator, **kwargs)

    def round_masks(self, generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
        """Envelope-width failure draws, what every plan of the schedule
        consumes: index the edge mask by the active plan's own edge ids."""
        return _draw_failure_masks(self.failures, self.n_edges_env, self.n, generator)

    def wire_messages(self, round_index, generator: torch.Generator | None = None, **kwargs):
        """``CommPlan.wire_messages`` of the plan active at ``round_index``
        (the same keywords: ``active``, ``edge_live``): two messages a live
        edge of that plan."""
        return self.select(round_index).wire_messages(generator, **kwargs)

    def stacked_csr(self) -> dict[str, torch.Tensor]:
        """Every plan's CSR view padded to one envelope, on the device:
        ``indptr`` (K, n + 1), ``indices`` / ``uid`` (K, nnz_env), ``deg``
        (K, n) int64 and ``degrees`` (K, n) float32."""
        graphs = [p.graph for p in self.plans]
        csrs = [g.csr() for g in graphs]
        nnz = max(len(c[1]) for c in csrs)
        i64 = lambda a: torch.as_tensor(np.stack(a), dtype=torch.int64, device=self.device)  # noqa: E731
        return dict(
            indptr=i64([c[0] for c in csrs]),
            indices=i64([np.pad(c[1], (0, nnz - len(c[1]))) for c in csrs]),
            uid=i64([np.pad(c[2], (0, nnz - len(c[2]))) for c in csrs]),
            deg=i64([np.diff(c[0]) for c in csrs]),
            degrees=torch.as_tensor(np.stack([g.degrees for g in graphs]), dtype=torch.float32, device=self.device),
        )

    def with_options(
        self,
        *,
        backend: str | None = None,
        data_sizes: np.ndarray | None = None,
        failures: FailureModel | None = None,
    ) -> "PlanSchedule":
        """Recompile the whole schedule with some knobs replaced."""
        return compile_schedule(
            [p.graph for p in self.plans],
            backend=backend or self.backend,
            data_sizes=self.data_sizes if data_sizes is None else data_sizes,
            failures=failures or self.failures,
            round_map=self.round_map,
            device=self.device,
        )

    # ------------------------------------------------- event-driven execution
    @staticmethod
    def _window(time) -> int:
        """Unit-time window of an event timestamp (one window a round)."""
        return int(np.floor(np.float32(time)))

    def event_key(self, seed: int | None, time) -> int | None:
        """The seed an event at ``time`` draws its failure flag from: K = 1
        keeps ``seed`` (the static plan's draws, bit for bit); K > 1 mixes
        in the plan active in the event's window, so resampled plans draw
        independent outages (the JAX package folds the plan id into the
        event's key)."""
        if seed is None or self.k == 1:
            return seed
        p = self.plan_index(self._window(time))
        return int(np.random.SeedSequence([int(seed), p]).generate_state(1, np.uint64)[0])

    def event_mix(self, params, edge, time, keep: bool | None = None):
        """One asynchronous DecAvg event under the plan active at ``time``;
        ``edge`` indexes that plan's own ``Graph.edge_list()`` (``event_stream``
        samples streams with per-window edge ids)."""
        return self.select(self._window(time)).event_mix(params, edge, keep)

    def event_spread(self, values, edge, time, keep: bool | None = None) -> torch.Tensor:
        """One asynchronous push event under the plan active at ``time``."""
        return self.select(self._window(time)).event_spread(values, edge, keep)

    def event_spread_min(self, values, edge, time, keep: bool | None = None) -> torch.Tensor:
        """One asynchronous min event under the plan active at ``time``."""
        return self.select(self._window(time)).event_spread_min(values, edge, keep)

    def event_stream(self, horizon: float, rate: float = 1.0, seed: int = 0) -> EventStream:
        """Sample a Poisson edge-clock stream over the schedule: window w
        draws its events from the plan active in it (``plan_index(w)``, on
        the host), seed ``seed + w``, edge ids in that plan's edge order;
        the windows concatenate into one sorted stream.  K = 1 is the
        static sampler, bit for bit."""
        if self.k == 1:
            return poisson_event_stream(self.plans[0].graph, horizon, rate=rate, seed=seed)
        n_windows = int(np.ceil(horizon))
        times, edges = [], []
        for w in range(n_windows):
            g = self.plans[self.plan_index(w)].graph
            span = min(1.0, horizon - w)
            win = poisson_event_stream(g, span, rate=rate, seed=seed + w)
            k = win.n_events
            times.append(np.asarray(win.times[:k]) + w)
            edges.append(np.asarray(win.edges[:k]))
        t = np.concatenate(times) if times else np.zeros(0, np.float64)
        e = np.concatenate(edges) if edges else np.zeros(0, np.int32)
        return EventStream(
            times=np.asarray(t, np.float32),
            edges=np.asarray(e, np.int32),
            n_events=len(t),
            horizon=float(horizon),
            rates=np.full(len(self.plans[0].graph.edge_list()), float(rate)),
        )


def compile_schedule(
    graphs: Sequence[Graph],
    backend: str = "auto",
    data_sizes: np.ndarray | Sequence[float] | None = None,
    failures: FailureModel | None = None,
    round_map: RoundMap | None = None,
    device: str | torch.device | None = None,
) -> PlanSchedule:
    """Lower K graphs and a round → plan map into a ``PlanSchedule`` on
    ``device`` (default cuda).

    Every graph compiles through ``compile_plan`` with the same backend,
    data sizes and failure model; ``round_map`` defaults to ``cyclic_map(1)``.
    Each plan's failure-draw width is set here, once, to the envelope (the
    largest edge count), so no round copies a plan and each keeps its
    lazily built Mᵀ.  ``topology.churn_sequence`` builds churned graph
    sequences to feed here.
    """
    graphs = list(graphs)
    if not graphs:
        raise ValueError("compile_schedule needs at least one graph")
    if len({g.n for g in graphs}) != 1:
        raise ValueError(f"all plans in a schedule must share the node count, got {[g.n for g in graphs]}")
    if backend == "auto":
        backend = "dense" if graphs[0].n <= 64 else "sparse"
    plans = [compile_plan(g, backend=backend, data_sizes=data_sizes, failures=failures, device=device)
             for g in graphs]
    round_map = round_map or cyclic_map(1)
    if round_map.kind == "sequence" and int(np.max(round_map.sequence)) >= len(plans):
        raise ValueError(
            f"round map references plan {int(np.max(round_map.sequence))} but the "
            f"schedule holds only {len(plans)} plans"
        )
    env = max(p.n_edges for p in plans)
    plans = tuple(p if p.n_edges == env else dataclasses.replace(p, n_edges_draw=env) for p in plans)
    return PlanSchedule(plans=plans, round_map=round_map, n_edges_env=env)
