"""DecAvg aggregation (paper Eq. 2) as plain PyTorch (counterpart of ``repro/core/decavg.py``).

These are the plain renderings the tests hold ``CommPlan.mix`` and the
JAX package against; on the card ``CommPlan.mix`` runs the hand-written
kernels of ``repro_torch.kernels.mix`` instead.  The edge-coloured
(``ppermute``) and circulant schedules have no kernel in the JAX package
either: their single-device renderings here are node-axis gathers and rolls,
and ``CommPlan.mix`` runs the colour schedule through ``mix_pytree_colored``
on every device.  Given a ``process_group`` (one node a rank, the node
axis of ``launch.mesh.node_group``) both run as collectives instead, the
JAX package's ``ppermute`` rounds: one ``batch_isend_irecv`` exchange a
colour, or a send/receive pair a circulant term (``exchange``).  All accumulate in fp32 regardless of the parameter dtype
(the mixing weights are O(1/k) and the post-diffusion scale is the signal
bf16 accumulation would lose).

The event-driven (asynchronous) exchanges move only an edge's two
endpoints: ``mix_pytree_pairwise`` blends them in the JAX form
``x_u + w_uv·(x_v − x_u)``, as separate fp32 sub, mul and add, so the CPU
and the card round alike; ``mix_pytree_pairwise_batch`` applies a matching
of such exchanges at once, each row written once by index assignment (no
``index_add_``, which CUDA accumulates with atomics); ``spread_pairwise``
and ``spread_min_pairwise`` are the push and min forms.  Endpoints are host
ints, weights fp32 tensors (scalars or ``(W,)``) on the data's device.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.mix.ref import decavg_mix_ref, pair_mix_ref

from .topology import Graph

__all__ = [
    "exchange",
    "failure_receive_matrix",
    "link_failure_mask",
    "mix_array",
    "mix_pytree",
    "mix_pytree_circulant",
    "mix_pytree_colored",
    "mix_pytree_pairwise",
    "mix_pytree_pairwise_batch",
    "mix_pytree_sparse",
    "node_failure_mask",
    "spread_min_pairwise",
    "spread_pairwise",
]

Tree = dict[str, Any]


def _map(fn, tree: Tree) -> Tree:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _map_params(fn, params):
    """``fn`` over a flat (n, d) buffer or over every leaf of a node-stacked dict."""
    return fn(params) if isinstance(params, torch.Tensor) else _map(fn, params)


def _bcast(w: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a 1-D weight vector to broadcast over ``ndim - 1`` trailing dims."""
    return w.reshape(w.shape + (1,) * (ndim - 1))


def exchange(sends: Sequence[torch.Tensor], peers: Sequence[tuple[int, int]], process_group) -> list[torch.Tensor]:
    """Point-to-point rounds over ``process_group``: round j sends
    ``sends[j]`` to group rank ``peers[j][0]`` and receives a tensor of its
    shape from ``peers[j][1]``, one ``batch_isend_irecv`` a round.  A round
    whose peers are both this rank moves nothing and returns ``sends[j]``
    itself.  Returns the received tensors in round order."""
    me = dist.get_rank(process_group)
    out = []
    for x, (to, frm) in zip(sends, peers):
        if to == me and frm == me:
            out.append(x)
            continue
        x = x.contiguous()
        buf = torch.empty_like(x)
        ops = [
            dist.P2POp(dist.isend, x, dist.get_global_rank(process_group, to), process_group),
            dist.P2POp(dist.irecv, buf, dist.get_global_rank(process_group, frm), process_group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out.append(buf)
    return out


def _one_node_a_rank(process_group, n: int, what: str) -> int:
    size = dist.get_world_size(process_group)
    if size != n:
        raise ValueError(f"the collective {what} runs one node a rank: group size {size} != n {n}")
    return dist.get_rank(process_group)


def mix_array(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x_new[i] = Σ_j m[i, j] x[j]`` over the leading node axis: the
    kernels' plain version on ``x`` flattened to (n, d)."""
    return decavg_mix_ref(m, x.reshape(x.shape[0], -1)).reshape(x.shape)


def mix_pytree(m: torch.Tensor, params: Tree) -> Tree:
    """Dense DecAvg over every leaf of a node-stacked dict."""
    return _map(lambda w: mix_array(m, w), params)


def mix_pytree_sparse(
    params: Tree,
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_w: torch.Tensor,
    self_w: torch.Tensor,
    *,
    n_nodes: int,
) -> Tree:
    """DecAvg by edge-list gather-scatter (CSR order, dst-sorted):
    ``out[i] = self_w[i]·x[i] + Σ_{e: dst[e]=i} edge_w[e]·x[src[e]]``.

    CPU only: ``index_add_`` accumulates with atomics on CUDA, whose order —
    and so whose fp32 result — changes from run to run.  The card path sums
    in the fixed tile order of the block-sparse kernel instead.
    """

    def mix_leaf(x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cpu":
            raise ValueError("mix_pytree_sparse is the CPU reference; on CUDA use CommPlan.mix")
        contrib = _bcast(edge_w, x.ndim) * x.index_select(0, src).to(torch.float32)
        agg = torch.zeros((n_nodes, *x.shape[1:]), dtype=torch.float32).index_add_(0, dst, contrib)
        out = _bcast(self_w, x.ndim) * x.to(torch.float32) + agg
        return out.to(x.dtype)

    return _map(mix_leaf, params)


def mix_pytree_colored(
    params: torch.Tensor | Tree,
    partners: np.ndarray | torch.Tensor,
    color_w: torch.Tensor,
    self_w: torch.Tensor,
    *,
    process_group=None,
) -> torch.Tensor | Tree:
    """DecAvg over an edge-coloured schedule (any undirected graph):
    ``out[i] = self_w[i]·x[i] + Σ_c color_w[c, i]·x[partners[c, i]]``.

    ``partners`` is the (n_colors, n) table of per-colour matchings, each an
    involution (``partners[c, i] == i`` where i is unmatched); ``color_w``
    (n_colors, n) the normalised receive weight of edge (i, partners[c, i])
    at node i (0 when unmatched); ``self_w`` (n,).  One gather of the
    ensemble a colour, accumulated in fp32 in the JAX package's order (the
    self term, then colour 0, 1, …), so no atomics and reruns are bitwise.
    ``params`` is a flat (n, d) buffer or a node-stacked dict; leaf dtypes
    are kept.

    With a ``process_group`` of n ranks (one node a rank, the JAX
    ``axis_name`` form) ``params`` is this rank's node, a (1, d) buffer or a
    dict of (1, ...) leaves, ``color_w`` its (n_colors, 1) column and
    ``self_w`` its (1,) entry; ``partners`` stays the full host table.  Each
    colour is one ``batch_isend_irecv`` exchange with the rank's partner
    (``exchange``); an unmatched rank takes its own row, as the gather does,
    so the sums are the single-device rendering's."""
    if process_group is not None:
        table = np.asarray(partners)
        me = _one_node_a_rank(process_group, table.shape[1], "edge-coloured mix")
        peers = [(int(p), int(p)) for p in table[:, me]]

        def mix_leaf_collective(x: torch.Tensor) -> torch.Tensor:
            acc = _bcast(self_w, x.ndim) * x.to(torch.float32)
            for c, got in enumerate(exchange([x] * len(peers), peers, process_group)):
                acc = acc + _bcast(color_w[c], x.ndim) * got.to(torch.float32)
            return acc.to(x.dtype)

        return _map_params(mix_leaf_collective, params)

    def mix_leaf(x: torch.Tensor) -> torch.Tensor:
        idx = torch.as_tensor(partners, dtype=torch.int64, device=x.device)
        acc = _bcast(self_w, x.ndim) * x.to(torch.float32)
        for c in range(idx.shape[0]):
            acc = acc + _bcast(color_w[c], x.ndim) * x.index_select(0, idx[c]).to(torch.float32)
        return acc.to(x.dtype)

    return _map_params(mix_leaf, params)


def mix_pytree_circulant(
    params: torch.Tensor | Tree,
    offsets: Sequence[int],
    weights: torch.Tensor | None = None,
    *,
    process_group=None,
) -> torch.Tensor | Tree:
    """Circulant DecAvg on one device: node i mixes itself and i ∓ s for
    every offset s.  The JAX package renders it inside ``shard_map`` with
    one ``ppermute`` a term, pairs (i, i + s): node j receives node j − s,
    which is ``torch.roll(x, s)`` along the node axis here.  ``weights``
    ((2|S| + 1,), default uniform 1/(2|S| + 1)) in the JAX term order
    [self, +s1, −s1, +s2, …], accumulated in fp32 in that order.

    With a ``process_group`` (one node a rank, the group's size the node
    count) ``params`` is this rank's node, (1, ...), and each term is one
    send/receive pair: node i sends to i + s and receives from i − s, the
    JAX ``ppermute`` pairs, in the same term order."""
    n_terms = 2 * len(offsets) + 1
    terms = [sign * int(s) for s in offsets for sign in (1, -1)]

    def term_weights(device) -> torch.Tensor:
        return (torch.full((n_terms,), 1.0 / n_terms, dtype=torch.float32) if weights is None
                else torch.as_tensor(weights, dtype=torch.float32)).to(device)

    if process_group is not None:
        size = dist.get_world_size(process_group)
        me = dist.get_rank(process_group)
        peers = [((me + t) % size, (me - t) % size) for t in terms]

        def mix_leaf_collective(x: torch.Tensor) -> torch.Tensor:
            w = term_weights(x.device)
            acc = w[0] * x.to(torch.float32)
            for t, got in enumerate(exchange([x] * len(peers), peers, process_group), start=1):
                acc = acc + w[t] * got.to(torch.float32)
            return acc.to(x.dtype)

        return _map_params(mix_leaf_collective, params)

    def mix_leaf(x: torch.Tensor) -> torch.Tensor:
        w = term_weights(x.device)
        acc = w[0] * x.to(torch.float32)
        for t, shift in enumerate(terms, start=1):
            acc = acc + w[t] * torch.roll(x, shift, dims=0).to(torch.float32)
        return acc.to(x.dtype)

    return _map_params(mix_leaf, params)


def link_failure_mask(generator: torch.Generator, graph: Graph, p: float) -> torch.Tensor:
    """Symmetric Bernoulli(p) mask over the graph's edges (Fig. 2a): one
    uniform an upper-triangle pair, drawn as an (n, n) block on the
    generator's device; the adjacency's dtype."""
    a = torch.as_tensor(graph.adjacency, device=generator.device)
    u = torch.rand(a.shape, generator=generator, device=generator.device)
    keep = (torch.triu(u, diagonal=1) < p) & (torch.triu(a, diagonal=1) > 0)
    return (keep | keep.T).to(a.dtype)


def node_failure_mask(generator: torch.Generator, graph: Graph, p: float) -> torch.Tensor:
    """The adjacency with every edge of an inactive node removed (Fig. 2b),
    each node active with probability p.  An inactive node neither sends nor
    receives this round but keeps training locally."""
    a = torch.as_tensor(graph.adjacency, device=generator.device)
    active = torch.rand(graph.n, generator=generator, device=generator.device) < p
    return (a * (active[:, None] & active[None, :])).to(a.dtype)


def failure_receive_matrix(
    adjacency: torch.Tensor, data_sizes: torch.Tensor | None = None
) -> torch.Tensor:
    """Row-stochastic receive operator for a (possibly masked) adjacency —
    ``core.mixing.receive_matrix`` on the device, in fp32."""
    n = adjacency.shape[0]
    b = adjacency.to(torch.float32) + torch.eye(n, dtype=torch.float32, device=adjacency.device)
    if data_sizes is not None:
        b = b * data_sizes[None, :].to(torch.float32)
    return b / b.sum(dim=1, keepdim=True)


# ------------------------------------------------ event-driven exchanges
def _weight(w, device) -> torch.Tensor:
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def mix_pytree_pairwise(params: torch.Tensor | Tree, u: int, v: int, w_uv, w_vu) -> torch.Tensor | Tree:
    """One event-driven DecAvg exchange on edge (u, v) (paper Eq. 2 for a
    pair): ``w_u ← w_u + w_uv·(w_v − w_u)`` and symmetrically, everyone else
    untouched.  ``w_uv`` / ``w_vu`` are normally the plan's receive entries
    M[u, v] / M[v, u]; weights 0 are the identity.  Returns a new buffer or
    tree; the input is not written."""

    def mix_leaf(x: torch.Tensor) -> torch.Tensor:
        w = torch.stack([_weight(w_uv, x.device), _weight(w_vu, x.device)])
        new = pair_mix_ref(torch.stack([x[u], x[v]]), w)
        out = x.clone()
        out[u], out[v] = new[0], new[1]
        return out

    return _map_params(mix_leaf, params)


def _matching(u: np.ndarray, v: np.ndarray) -> None:
    ends = np.concatenate([u, v])
    if len(np.unique(ends)) != len(ends):
        raise ValueError("a batch of exchanges must be endpoint-disjoint (a matching)")


def mix_pytree_pairwise_batch(params: torch.Tensor | Tree, u, v, w_uv, w_vu) -> torch.Tensor | Tree:
    """One colour step: W simultaneous exchanges on endpoint-disjoint edges.

    ``u`` / ``v`` are (W,) host int arrays, ``w_uv`` / ``w_vu`` (W,) fp32
    weights.  The edges must form a matching (padding dropped by the
    caller), so the W sequential exchanges commute: each endpoint row is
    gathered, blended in the form of ``mix_pytree_pairwise`` and written
    back once, by index assignment.  Bitwise the sequential exchanges."""
    u, v = np.asarray(u, np.int64), np.asarray(v, np.int64)
    _matching(u, v)

    def mix_leaf(x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        if len(u) == 0:
            return out
        iu, iv = torch.as_tensor(u, device=x.device), torch.as_tensor(v, device=x.device)
        xu, xv = x[iu].to(torch.float32), x[iv].to(torch.float32)
        out[iu] = (xu + _bcast(_weight(w_uv, x.device), xu.ndim) * (xv - xu)).to(x.dtype)
        out[iv] = (xv + _bcast(_weight(w_vu, x.device), xv.ndim) * (xu - xv)).to(x.dtype)
        return out

    return _map_params(mix_leaf, params)


def spread_pairwise(values: torch.Tensor, u: int, v: int, w_uv, w_vu) -> torch.Tensor:
    """One event-driven push exchange on edge (u, v), mass-conserving: u
    hands ``w_uv·s_u`` to v and receives ``w_vu·s_v`` —
    ``s_u ← s_u − w_uv·s_u + w_vu·s_v`` and symmetrically, so ``s_u + s_v``
    is kept for any weights.  (n,) or (n, k) fp32; a new tensor."""
    x = values.to(torch.float32)
    xu, xv = x[u], x[v]
    give_u, give_v = _weight(w_uv, x.device) * xu, _weight(w_vu, x.device) * xv
    out = x.clone()
    out[u], out[v] = xu - give_u + give_v, xv - give_v + give_u
    return out


def spread_min_pairwise(values: torch.Tensor, u: int, v: int) -> torch.Tensor:
    """One event-driven min exchange on edge (u, v): both endpoints take the
    elementwise minimum, the event transport of the leaderless size
    sketches.  A new tensor."""
    out = values.to(torch.float32).clone()
    lo = torch.minimum(out[u], out[v])
    out[u], out[v] = lo, lo
    return out
