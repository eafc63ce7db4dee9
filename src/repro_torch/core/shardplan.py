"""Node-sharded rendering of a ``CommPlan`` over ``torch.distributed``
(counterpart of ``repro/core/shardplan.py``, DESIGN.md §15).

The process model.  The JAX package runs its sharded round from one
controller inside ``shard_map`` over a 1-D ``Mesh``; the port is SPMD over
processes.  One process a shard: rank r owns the contiguous node rows
``[r·nps, (r+1)·nps)``, exactly as ``shard_plan`` partitions them, and one
process group (``launch.mesh.node_group``) stands where the mesh axis
stood.  Every rank compiles the same ``CommPlan`` on its own device and
calls the same operations in the same order.  On the card each rank takes
``cuda:{local_rank}`` and NCCL; with ``device="cpu"`` the CPU and gloo.
There is no fallback: a plan on one kind of device over a group of the
other backend raises, as does a group of another size.

Renderings, each through the port's kernels in their row-block form:

* ``sparse``: the JAX package's receive layout (``_build_layout``, its
  tables equal to the JAX ones for the same plan): a rank's in-edges are one
  contiguous slice of the dst-sorted CSR, and the remote endpoints it needs
  arrive by ONE ``all_to_all_single`` of the padded (S, h_max, d) send block
  a round, appended to the local rows in a fixed order (``[local | halo]``).
  The rank's rows of the operator are a BSR over that buffer, built once per
  plan (``_LocalOp``), and the block-sparse kernel (#2) mixes ``nps`` output
  rows over the ``nps + S·h_max`` buffer rows.  A masked round writes the
  surviving raw weights into zeroed tiles by slot and divides each row by its
  own sum, as the unsharded plan does.  ``spread`` runs the src-sorted layout
  the same way; ``spread_min`` the receive layout with a scatter min.
* ``dense``: one all-gather of the payload, then the rank's (nps, n) rows of
  the round matrix through the dense kernel (#1).
* ``ppermute``: one node a rank, each colour one ``batch_isend_irecv``
  exchange (``decavg.mix_pytree_colored``'s process-group form).

The JAX package's clean-path HYB tables (its ELL slot chain and the hub rows
contracted against an all-gathered payload) are not ported: the port's
unsharded plan has no HYB rendering either, so a graph with hub rows needs
no hub all-gather and its traffic counts differ from the JAX counts there
(ROADMAP.md Queue 3).

Failure draws stay global: every rank draws the full (n_edges,) / (n,)
masks from its CPU ``torch.Generator``, in the same state on every rank, so
a round's masks are those of the unsharded plan.  At one shard the round is
the unsharded plan's, bit for bit (the same tiles, the same kernel call).
At more shards a row sums its terms in the ``[local | halo]`` order, so the
result is the unsharded one to fp32 rounding, not bitwise (the JAX package's
segment-sum rendering keeps the order; the kernels' walk goes by column).
``spread_min`` is exact at any shard count.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.flat import tree_leaves, tree_structure, tree_unflatten
from repro_torch.kernels.mix import BSR, bsr_slots, mix_flat
from repro_torch.kernels.mix.ops import per_dtype

from .commplan import CommPlan
from .decavg import exchange, mix_pytree_colored

__all__ = ["ShardedCommPlan", "all_gather_rows", "shard_plan"]


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(nps, ...) on every rank → (S·nps, ...), rank order, one collective."""
    size = dist.get_world_size(group)
    if size == 1:
        return x
    x = x.contiguous()
    out = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    # torch 2.13 renames all_gather_into_tensor to all_gather_single and
    # deprecates the old name; earlier releases have only the old one
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=group)
    return out


# ---------------------------------------------------------------------------
# host-side layout compilation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Layout:
    """One sharded edge layout (receive- or send-sorted) and its halo plan,
    numpy, every table with a leading (n_shards, ...) axis.

    ``seg``    (S, E) local segment index of the *owning* endpoint (padding
               entries point at the dummy segment ``nps``);
    ``gat``    (S, E) gather index into the ``[local | halo]`` buffer;
    ``uid``    (S, E) global undirected edge id (failure-draw key);
    ``gown``/``gfar`` (S, E) global ids of the owning / gathered endpoint;
    ``perm``   (S, E) position of the edge in the global receive CSR;
    ``send``   (S, S, H) local rows shard q ships to every other shard,
               padded per pair to the uniform width ``h_max`` so the whole
               halo moves as ONE ``all_to_all_single`` a round.
    """

    nps: int
    n_shards: int
    h_max: int
    seg: np.ndarray
    gat: np.ndarray
    uid: np.ndarray
    edge_w: np.ndarray
    raw_edge_w: np.ndarray
    gown: np.ndarray
    gfar: np.ndarray
    valid: np.ndarray
    perm: np.ndarray
    self_w: np.ndarray  # (S, nps) statically normalised self weights
    raw_self_w: np.ndarray  # (S, nps)
    send: np.ndarray  # (S, S, max(h_max, 1))
    # pos[s][global node] → row in shard s's ``[local | halo]`` buffer
    pos: tuple[dict, ...] = ()

    def tables(self) -> dict[str, np.ndarray]:
        """The per-shard tables, by the JAX package's names."""
        return {k: getattr(self, k) for k in ("seg", "gat", "uid", "edge_w", "raw_edge_w", "gown", "gfar", "valid",
                                               "perm", "self_w", "raw_self_w", "send")}

    @property
    def halo_rows(self) -> int:
        """Rows each shard ships to other shards a round: the padded
        exchange width times the S − 1 remote destinations (the q → q block
        never leaves the rank)."""
        return (self.n_shards - 1) * self.h_max

    @property
    def buffer_rows(self) -> int:
        """Rows of a shard's ``[local | halo]`` buffer."""
        return self.nps + (self.n_shards * self.h_max if self.n_shards > 1 else 0)


def _build_layout(
    n: int,
    n_shards: int,
    own: np.ndarray,
    far: np.ndarray,
    uid: np.ndarray,
    edge_w: np.ndarray,
    raw_edge_w: np.ndarray,
    perm: np.ndarray,
    self_w: np.ndarray,
    raw_self_w: np.ndarray,
) -> _Layout:
    """Compile one (own-sorted) edge layout into per-shard tables and a halo
    plan, the JAX package's ``_build_layout`` table for table.

    ``own`` is sorted ascending (dst for the receive layout, src for the
    send layout); shard s's edges are the contiguous slice whose owner falls
    in ``[s·nps, (s+1)·nps)``.  Halo rows are the sorted unique remote
    endpoints, laid out per source shard in ascending shard order at the
    uniform width ``h_max``.
    """
    nps = n // n_shards
    bounds = np.searchsorted(own, np.arange(1, n_shards + 1) * nps)
    starts = np.concatenate([[0], bounds[:-1]])
    env = max(int((bounds - starts).max()), 1)

    # remote needs: needs[s][q] = sorted global nodes shard s pulls from q
    needs: list[dict[int, np.ndarray]] = [{} for _ in range(n_shards)]
    for s in range(n_shards):
        f = far[starts[s] : bounds[s]]
        remote = f[(f < s * nps) | (f >= (s + 1) * nps)]
        for q in np.unique(remote // nps):
            needs[s][int(q)] = np.unique(remote[remote // nps == q])

    h_max = max((len(nd) for ns in needs for nd in ns.values()), default=0)
    pos: list[dict[int, int]] = [{} for _ in range(n_shards)]
    send = np.zeros((n_shards, n_shards, max(h_max, 1)), np.int32)
    for s in range(n_shards):
        for q, nd in needs[s].items():
            send[q, s, : len(nd)] = (nd - q * nps).astype(np.int32)
            for j, g in enumerate(nd):
                # buffer: [local | recv block of shard 0 | shard 1 | …]
                pos[s][int(g)] = nps + q * h_max + j

    seg = np.full((n_shards, env), nps, np.int32)
    gat = np.zeros((n_shards, env), np.int32)
    uid_t = np.zeros((n_shards, env), np.int32)
    ew_t = np.zeros((n_shards, env), np.float32)
    rew_t = np.zeros((n_shards, env), np.float32)
    gown_t = np.zeros((n_shards, env), np.int32)
    gfar_t = np.zeros((n_shards, env), np.int32)
    valid_t = np.zeros((n_shards, env), bool)
    perm_t = np.zeros((n_shards, env), np.int32)
    for s in range(n_shards):
        sl = slice(starts[s], bounds[s])
        m = bounds[s] - starts[s]
        lo = s * nps
        f = far[sl]
        seg[s, :m] = (own[sl] - lo).astype(np.int32)
        gat[s, :m] = [int(g) - lo if lo <= g < lo + nps else pos[s][int(g)] for g in f]
        uid_t[s, :m] = uid[sl]
        ew_t[s, :m] = edge_w[sl]
        rew_t[s, :m] = raw_edge_w[sl]
        gown_t[s, :m] = own[sl]
        gfar_t[s, :m] = f
        valid_t[s, :m] = True
        perm_t[s, :m] = perm[sl]

    return _Layout(
        nps=nps, n_shards=n_shards, h_max=h_max, seg=seg, gat=gat, uid=uid_t, edge_w=ew_t, raw_edge_w=rew_t,
        gown=gown_t, gfar=gfar_t, valid=valid_t, perm=perm_t,
        self_w=np.asarray(self_w, np.float32).reshape(n_shards, nps),
        raw_self_w=np.asarray(raw_self_w, np.float32).reshape(n_shards, nps),
        send=send, pos=tuple(pos),
    )


def _row_block_structure(rows: np.ndarray, cols: np.ndarray, n_rows: int, bn: int) -> tuple[np.ndarray, np.ndarray]:
    """(block_cols (nrb, max_nnz) int32, counts (nrb,) int32) of the tiles
    holding the entries (rows[e], cols[e]): each row block's column blocks
    ascending, short row blocks padded with column block 0 —
    ``bsr_from_dense``'s structure of the same pattern."""
    nrb = -(-n_rows // bn)
    ncb = int(cols.max(initial=0)) // bn + 1
    pairs = np.unique((rows // bn).astype(np.int64) * ncb + cols // bn)
    rb, cb = pairs // ncb, pairs % ncb
    counts = np.bincount(rb, minlength=nrb).astype(np.int32)
    block_cols = np.zeros((nrb, max(int(counts.max(initial=0)), 1)), np.int32)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    block_cols[rb, np.arange(len(pairs)) - first[rb]] = cb
    return block_cols, counts


@dataclasses.dataclass(frozen=True)
class _LocalOp:
    """One rank's rows of an operator as a BSR over its ``[local | halo]``
    buffer: its static tiles, the flat tile slot of each of its layout's
    valid entries and of each diagonal entry, and the entries' tables on
    the device."""

    bsr: BSR
    edge_slot: torch.Tensor  # (m,) int64
    self_slot: torch.Tensor  # (nps,) int64
    seg: torch.Tensor  # (m,) int64 local row of each entry
    gat: torch.Tensor  # (m,) int64 buffer row of each entry
    uid: torch.Tensor  # (m,) int64
    gown: torch.Tensor  # (m,) int64
    gfar: torch.Tensor  # (m,) int64
    perm: torch.Tensor  # (m,) int64
    raw_edge_w: torch.Tensor  # (m,) fp32
    raw_self_w: torch.Tensor  # (nps,) fp32
    send_idx: torch.Tensor  # (S·h_max,) int64 rows of the halo send block
    n_cols: int


def _local_op(layout: _Layout, rank: int, bn: int, device: torch.device) -> _LocalOp:
    m = int(layout.valid[rank].sum())
    seg, gat = layout.seg[rank, :m].astype(np.int64), layout.gat[rank, :m].astype(np.int64)
    diag = np.arange(layout.nps, dtype=np.int64)
    block_cols, counts = _row_block_structure(np.concatenate([seg, diag]), np.concatenate([gat, diag]),
                                              layout.nps, bn)
    edge_slot = bsr_slots(block_cols, counts, seg, gat, bn)
    self_slot = bsr_slots(block_cols, counts, diag, diag, bn)
    tiles = np.zeros(block_cols.size * bn * bn, np.float32)
    tiles[edge_slot] = layout.edge_w[rank, :m]
    tiles[self_slot] = layout.self_w[rank]
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)  # noqa: E731
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return _LocalOp(
        bsr=BSR(block_cols=torch.as_tensor(block_cols, device=device),
                tiles=f32(tiles.reshape(*block_cols.shape, bn, bn)),
                counts=torch.as_tensor(counts, device=device)),
        edge_slot=i64(edge_slot), self_slot=i64(self_slot), seg=i64(seg), gat=i64(gat),
        uid=i64(layout.uid[rank, :m]), gown=i64(layout.gown[rank, :m]), gfar=i64(layout.gfar[rank, :m]),
        perm=i64(layout.perm[rank, :m]), raw_edge_w=f32(layout.raw_edge_w[rank, :m]),
        raw_self_w=f32(layout.raw_self_w[rank]),
        send_idx=i64(layout.send[rank, :, : layout.h_max].reshape(-1)), n_cols=layout.buffer_rows,
    )


def _refill(op: _LocalOp, edge_values: torch.Tensor, self_values: torch.Tensor) -> BSR:
    """``op``'s tiles with every entry's and diagonal's value written into
    zeroed tiles by slot (each slot once, nothing accumulates)."""
    flat = torch.zeros(op.bsr.tiles.numel(), dtype=torch.float32, device=op.bsr.tiles.device)
    flat[op.edge_slot] = edge_values
    flat[op.self_slot] = self_values
    return op.bsr._replace(tiles=flat.view(op.bsr.tiles.shape))


# ---------------------------------------------------------------------------
# the sharded plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedCommPlan:
    """A ``CommPlan`` rendered over a node-sharded process group.

    ``mix`` / ``spread`` / ``spread_min`` take globally shaped payloads,
    slice this rank's rows, run the local form and all-gather back, so they
    return globally shaped results (the gossip engine's operator protocol);
    they take ``CommPlan.mix``'s ``generator``, ``active`` and ``edge_live``.
    ``local_*`` run on this rank's (nps, ...) block (the sharded executor).
    Every rank must make the same calls in the same order.
    """

    base: CommPlan
    group: Any
    n_shards: int
    nps: int
    rank: int
    recv: _Layout | None = None  # sparse backend
    send: _Layout | None = None
    # the rank's device-side operators, made at first use and shared with
    # the failure-free twin (``_clean``)
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    # ------------------------------------------------------------- metadata
    @property
    def n(self) -> int:
        return self.base.n

    @property
    def graph(self):
        return self.base.graph

    @property
    def backend(self) -> str:
        return self.base.backend

    @property
    def failures(self):
        return self.base.failures

    @property
    def data_sizes(self):
        return self.base.data_sizes

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def n_edges(self) -> int:
        return self.base.n_edges

    @property
    def draw_width(self) -> int:
        return self.base.draw_width

    @property
    def rows(self) -> slice:
        """This rank's node rows."""
        return slice(self.rank * self.nps, (self.rank + 1) * self.nps)

    @functools.cached_property
    def _clean(self) -> "ShardedCommPlan":
        """This plan without its failure model, its operators shared: the
        gossip rounds take their draws as masks and run on it."""
        if not self.failures.active:
            return self
        return dataclasses.replace(self, base=self.base._clean)

    def round_masks(self, generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
        """The unsharded plan's per-round failure draws, replicated."""
        return self.base.round_masks(generator)

    def cross_shard_rows_per_round(self, op: str = "mix") -> int:
        """Rows moved between ranks a round, every collective of ``op``
        counted (static: the weak-scaling benchmark's traffic axis)."""
        if self.n_shards == 1:
            return 0
        if self.backend == "dense":
            return self.n_shards * (self.n - self.nps)
        if self.backend == "ppermute":
            # each colour moves the row of every matched node
            return int((self.base.partners != np.arange(self.n)[None, :]).sum())
        layout = self.send if op == "spread" else self.recv
        return self.n_shards * layout.halo_rows

    def collectives_per_round(self, op: str = "mix") -> int:
        """Collective launches a round per payload buffer (static)."""
        if self.n_shards == 1:
            return 0
        if self.backend == "dense":
            return 1
        if self.backend == "ppermute":
            return sum(1 for p in self.base.color_perms() if p)
        layout = self.send if op == "spread" else self.recv
        return 1 if layout.h_max else 0

    def cross_shard_bytes_per_round(self, row_bytes: int, op: str = "mix") -> int:
        """Traffic between ranks a round for ``row_bytes`` a node row."""
        return self.cross_shard_rows_per_round(op) * row_bytes

    # ----------------------------------------------------------- primitives
    def _op(self, name: str) -> _LocalOp:
        """The rank's receive (``"recv"``) or send (``"send"``) operator."""
        if name not in self._cache:
            self._cache[name] = _local_op(getattr(self, name), self.rank, self.base.bsr.block_n, self.device)
        return self._cache[name]

    def _halo(self, x: torch.Tensor, op: _LocalOp) -> torch.Tensor:
        """(nps, k) local block → (nps + S·h_max, k) ``[local | halo]``: ONE
        ``all_to_all_single`` moves every rank's padded send blocks, the
        block of source rank q landing at rows ``nps + q·h_max``."""
        if op.n_cols == self.nps:
            return x
        buf = x.index_select(0, op.send_idx)
        got = torch.empty_like(buf)
        dist.all_to_all_single(got, buf, group=self.group)
        return torch.cat([x, got], dim=0)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather_rows(x, self.group)

    def _recv_round(self, generator, active, edge_live) -> BSR:
        """This round's rows of M over the receive buffer: the static tiles,
        or the surviving raw weights renormalised over each row's own sum
        (the unsharded ``_sparse_round_bsr`` on the rank's tiles)."""
        op = self._op("recv")
        if not self.base._masked(active, edge_live):
            return op.bsr
        edge_keep, node_act = self.base._round_masks_ext(generator, active, edge_live)
        keep = edge_keep[op.uid] & node_act[op.gfar] & node_act[op.gown]
        bsr = _refill(op, op.raw_edge_w * keep, op.raw_self_w)
        den = bsr.tiles.sum(dim=(1, 3), keepdim=True)
        return bsr._replace(tiles=bsr.tiles / torch.where(den > 0, den, torch.ones_like(den)))

    def _send_round(self, generator, active, edge_live) -> BSR:
        """This round's rows of Mᵀ over the send buffer.  A masked round's
        denominators are indexed by the remote destination, so every rank
        renormalises the whole of M (replicated elementwise work, as the JAX
        package replays its global reduction) and reads its entries off."""
        op = self._op("send")
        if not self.base._masked(active, edge_live):
            return op.bsr
        m_flat = self.base._sparse_round_bsr(generator, active, edge_live).tiles.reshape(-1)
        return _refill(op, m_flat[self.base.edge_slot[op.perm]], m_flat[self.base.self_slot[self.rows]])

    # -------------------------------------------------------- local bodies
    def local_mix(self, params, generator: torch.Generator | None = None, *, active=None, edge_live=None):
        """One DecAvg round on this rank's block: a flat (nps, d) buffer (one
        launch) or a dict of (nps, ...) leaves (one buffer a dtype)."""
        if self.failures.active and generator is None:
            raise ValueError("failure model active: the sharded mix needs a torch.Generator")
        base = self.base
        if self.backend == "ppermute":
            color_w, self_w = base.color_round_weights(generator, active=active, edge_live=edge_live)
            i = self.rank
            return mix_pytree_colored(params, base.partners, color_w[:, i : i + 1], self_w[i : i + 1],
                                      process_group=self.group)
        if self.backend == "dense":
            block = base._dense_round_matrix(generator, active, edge_live)[self.rows]
            mix_fn = lambda x: mix_flat(block, self._gather(x))  # noqa: E731
        else:
            op, bsr = self._op("recv"), self._recv_round(generator, active, edge_live)
            mix_fn = lambda x: mix_flat(bsr, self._halo(x, op), self.nps)  # noqa: E731
        return mix_fn(params) if isinstance(params, torch.Tensor) else per_dtype(mix_fn, params)

    def local_spread(self, x: torch.Tensor, generator=None, *, active=None, edge_live=None) -> torch.Tensor:
        """Send-form round (Mᵀ) on the (nps, k) fp32 local block."""
        base = self.base
        if self.backend == "ppermute":
            color_w, self_w = base.color_round_weights(generator, active=active, edge_live=edge_live)
            i = self.rank
            peers = [(int(p), int(p)) for p in base.partners[:, i]]
            # the mass a node pushes along its colour-c edge lands on the other endpoint
            got = exchange([color_w[c, i] * x for c in range(base.n_colors)], peers, self.group)
            recv = torch.stack(got) if got else x.new_zeros((0, *x.shape))
            return self_w[i] * x + recv.sum(dim=0)
        if self.backend == "dense":
            m = base._dense_round_matrix(generator, active, edge_live)
            return mix_flat(m[:, self.rows].T.contiguous(), self._gather(x))
        op, bsr = self._op("send"), self._send_round(generator, active, edge_live)
        return mix_flat(bsr, self._halo(x, op), self.nps)

    def local_spread_min(self, x: torch.Tensor, generator=None, *, active=None, edge_live=None) -> torch.Tensor:
        """Min-exchange round on the (nps, k) fp32 local block."""
        base = self.base
        masked = base._masked(active, edge_live)
        if masked:
            edge_keep, node_act = base._round_masks_ext(generator, active, edge_live)
        inf = torch.tensor(float("inf"), device=self.device)
        if self.backend == "ppermute":
            i = self.rank
            keep = base.color_edge_uid[:, i] >= 0
            if masked:
                keep = keep & edge_keep[base.color_edge_uid[:, i].clamp_min(0)]
                keep = keep & node_act[i] & node_act[base._partners_dev[:, i]]
            peers = [(int(p), int(p)) for p in base.partners[:, i]]
            got = exchange([x] * base.n_colors, peers, self.group)
            if not got:
                return torch.minimum(x, torch.full_like(x, float("inf")))
            cand = torch.where(keep[:, None, None], torch.stack(got), inf)
            return torch.minimum(x, cand.amin(dim=0))
        if self.backend == "dense":
            keep = base.adjacency > 0
            if masked:
                keep = keep & edge_keep[base.edge_uid_matrix] & node_act[:, None] & node_act[None, :]
            x_full = self._gather(x)
            nbr = torch.where(keep[self.rows][:, :, None], x_full[None, :, :], inf).amin(dim=1)
            return torch.minimum(x, nbr)
        op = self._op("recv")
        gathered = self._halo(x, op)[op.gat]
        if masked:
            keep = edge_keep[op.uid] & node_act[op.gfar] & node_act[op.gown]
            gathered = torch.where(keep[:, None], gathered, inf)
        index = op.seg[:, None].expand_as(gathered)
        nbr = torch.full_like(x, float("inf")).scatter_reduce_(0, index, gathered, "amin")
        return torch.minimum(x, nbr)

    # ------------------------------------------------------ public operator
    def _global(self, local_fn, values, generator, active, edge_live):
        if self.failures.active and generator is None:
            raise ValueError("failure model active: sharded ops need a torch.Generator")
        x = torch.as_tensor(values, dtype=torch.float32, device=self.device)
        x2 = x.reshape(self.n, -1)
        out = local_fn(x2[self.rows].contiguous(), generator, active=active, edge_live=edge_live)
        return self._gather(out).reshape(x.shape)

    def mix(self, params, generator: torch.Generator | None = None, *, active=None, edge_live=None):
        """One DecAvg aggregation of a globally shaped (n, d) buffer or dict
        of node-stacked leaves; the result globally shaped, on every rank."""
        local = tree_unflatten(tree_structure(params), [leaf[self.rows].contiguous()
                                                         for _, leaf in tree_leaves(params)])
        out = self.local_mix(local, generator, active=active, edge_live=edge_live)
        return tree_unflatten(tree_structure(out), [self._gather(leaf) for _, leaf in tree_leaves(out)])

    def spread(self, values, generator: torch.Generator | None = None, *, active=None, edge_live=None):
        """One send-form (column-stochastic) round: ``CommPlan.spread``."""
        return self._global(self.local_spread, values, generator, active, edge_live)

    def spread_min(self, values, generator: torch.Generator | None = None, *, active=None, edge_live=None):
        """One neighbourhood min-exchange round: ``CommPlan.spread_min``."""
        return self._global(self.local_spread_min, values, generator, active, edge_live)

    # ------------------------------------------------------------- plumbing
    def with_options(self, **kw) -> "ShardedCommPlan":
        """Recompile the base plan with some knobs replaced, re-sharded over
        the same group."""
        return shard_plan(self.base.with_options(**kw), group=self.group)


def _check_agree(plan: CommPlan, group, device: torch.device) -> None:
    """Every rank must hold the same plan: one all-gather of its summary
    (also the group's first collective, which every rank joins)."""
    mine = torch.tensor([plan.n, plan.n_edges, plan.draw_width, "dsp".index(plan.backend[0]),
                         int(plan.failures.link_p * 2**20), int(plan.failures.node_p * 2**20)],
                        dtype=torch.int64, device=device)
    every = all_gather_rows(mine[None], group)
    if not bool((every == mine[None]).all()):
        raise ValueError(f"the ranks hold different plans: {every.tolist()}")


def shard_plan(plan: CommPlan, *, group=None, n_shards: int | None = None) -> ShardedCommPlan:
    """Render a compiled ``CommPlan`` over a node-sharded process group.

    ``group`` names the node axis (``launch.mesh.node_group``); or give just
    ``n_shards`` and the group of that size is taken from the launcher (made
    here at one shard).  Nodes are partitioned contiguously — rank r owns
    rows ``[r·nps, (r+1)·nps)`` — and ``n`` must divide evenly.  The
    ppermute backend runs one node a rank (``nps == 1``).  The plan's device
    must be the rank's: a CUDA plan needs an NCCL group, a CPU plan gloo.
    """
    from repro_torch.launch.mesh import backend_for, node_group  # launch builds on core

    if not isinstance(plan, CommPlan):
        raise TypeError(f"shard_plan renders a CommPlan, got {type(plan).__name__} (schedules are not sharded)")
    if group is None:
        if n_shards is None:
            raise ValueError("shard_plan needs a process group or an explicit n_shards")
        group = node_group(n_shards, device=plan.device)
    shards = dist.get_world_size(group)
    if n_shards is not None and n_shards != shards:
        raise ValueError(f"n_shards={n_shards} but the process group has {shards} ranks")
    want = backend_for(plan.device)
    if dist.get_backend(group) != want:
        raise ValueError(f"a plan on {plan.device} needs a {want} group, got {dist.get_backend(group)}")
    n = plan.n
    if n % shards:
        raise ValueError(f"n={n} nodes not divisible into {shards} shards")
    nps = n // shards
    rank = dist.get_rank(group)
    _check_agree(plan, group, plan.device)
    common = dict(base=plan, group=group, n_shards=shards, nps=nps, rank=rank)
    if plan.backend == "ppermute":
        if nps != 1:
            raise ValueError(
                "the ppermute backend shards one node per rank; use the sparse backend for "
                f"nodes-per-shard {nps} > 1"
            )
    if plan.backend != "sparse":
        return ShardedCommPlan(**common)
    recv, send = _layouts(plan, shards)
    return ShardedCommPlan(**common, recv=recv, send=send)


def _layouts(plan: CommPlan, n_shards: int) -> tuple[_Layout, _Layout]:
    """The receive (dst-sorted) and send (src-sorted) layouts of a sparse
    plan over ``n_shards`` shards, from the plan's CSR and its static tiles."""
    src, dst = plan.src.cpu().numpy(), plan.dst.cpu().numpy()
    uid = plan.edge_uid.cpu().numpy()
    tiles = plan.bsr.tiles.reshape(-1).cpu()
    edge_w = tiles[plan.edge_slot.cpu()].numpy()
    self_w = tiles[plan.self_slot.cpu()].numpy()
    raw_edge_w, raw_self_w = plan.raw_edge_w.cpu().numpy(), plan.raw_self_w.cpu().numpy()
    ident = np.arange(len(src), dtype=np.int32)
    n = plan.n
    recv = _build_layout(n, n_shards, dst, src, uid, edge_w, raw_edge_w, ident, self_w, raw_self_w)
    order = np.lexsort((dst, src))  # src-major, dst-minor: the send layout
    send = _build_layout(n, n_shards, src[order], dst[order], uid[order], edge_w[order], raw_edge_w[order],
                         ident[order], self_w, raw_self_w)
    return recv, send
