"""Gossip protocols for uncoordinated estimation, host numpy reference
(counterpart of ``repro/core/gossip.py``, paper §4.4, ref [35]).

The init gain needs ``‖v_steady‖``, which a node can estimate from (a) the
system size n and a known network-formation family, or (b) a polled sample of
the degree distribution.  Both are obtainable without coordination:

* ``push_sum``          — Kempe-style push-sum average consensus; averaging a
                          one-hot vector yields 1/n at every node (size
                          estimation), averaging local degrees yields ⟨k⟩.
* ``estimate_size``     — n̂ from push-sum of a leader one-hot.
* ``poll_degrees``      — random-walk degree polling with the excess-degree
                          (q(k)) bias corrected by importance re-weighting.

This module pins the semantics down with dense O(n²) operators; the engine
that runs them over the ``CommPlan`` mixing kernels is
``repro_torch.gossip``, held against the functions here.
``effective_send_matrix`` / ``push_sum_failures`` /
``power_iteration_norm_reference`` extend the reference to the failure and
power-iteration semantics the engine implements.  The ``event_*``
references pin down the barrier-free (asynchronous) exchanges that
``CommPlan.event_*`` and the engine's event protocols run.
"""
from __future__ import annotations

import numpy as np

from .mixing import mixing_matrix, receive_matrix
from .topology import Graph

__all__ = [
    "push_sum",
    "estimate_size",
    "estimate_mean_degree",
    "poll_degrees",
    "effective_send_matrix",
    "push_sum_failures",
    "power_iteration_norm_reference",
    "min_spread_reference",
    "estimate_size_sketch_reference",
    "event_mix_reference",
    "event_spread_reference",
    "event_spread_min_reference",
    "push_sum_events_reference",
]


def push_sum(graph: Graph, values: np.ndarray, rounds: int) -> np.ndarray:
    """Push-sum (ratio) gossip: every node tracks (s, w); both mix with the
    column-stochastic send weights; s/w converges to the true average at every
    node regardless of the non-doubly-stochastic mixing (mass conservation).
    """
    n = graph.n
    # column-stochastic send operator: node j sends 1/(k_j+1) to each of
    # itself and its neighbours — mass-conserving, as push-sum requires.
    ap = mixing_matrix(graph)  # columns sum to 1
    s = np.asarray(values, dtype=np.float64).copy()
    w = np.ones(n, dtype=np.float64)
    for _ in range(rounds):
        s = ap @ s
        w = ap @ w
    return s / w


def effective_send_matrix(
    graph: Graph, edge_keep: np.ndarray | None = None, node_active: np.ndarray | None = None
) -> np.ndarray:
    """Column-stochastic send operator of one round under a failure draw.

    ``edge_keep`` is indexed by ``Graph.edge_list()`` row (one Bernoulli per
    *undirected* edge, both endpoints agreeing — the same keying as
    ``CommPlan``'s training failures); ``node_active`` is per node.  An edge
    is usable iff it survived and both endpoints are active; every node
    always keeps its self-weight, so columns renormalise over the surviving
    neighbourhood and the matrix stays mass-conserving.  With no failures
    this is exactly ``mixing_matrix(graph)`` (Eq. 3); it also equals the
    transpose of the unit-data-size effective *receive* operator, which is
    what lets ``CommPlan.spread`` reuse the training backends.
    """
    n = graph.n
    a = graph.adjacency.astype(np.float64).copy()
    if edge_keep is not None:
        edges = graph.edge_list()
        dead = np.asarray(edge_keep) == 0
        if dead.any():
            u, v = edges[dead, 0], edges[dead, 1]
            a[u, v] = 0.0
            a[v, u] = 0.0
    if node_active is not None:
        act = np.asarray(node_active).astype(bool)
        a = a * act[:, None] * act[None, :]
    b = a + np.eye(n)
    return b / b.sum(axis=0, keepdims=True)


def push_sum_failures(
    graph: Graph, values: np.ndarray, send_matrices: list[np.ndarray]
) -> np.ndarray:
    """Push-sum through an explicit per-round sequence of send operators.

    Mass conservation makes the (s, w) ratio converge to the uniform average
    even though each round's operator (a failure draw) differs — this is the
    reference the engine's failure-parity tests integrate against.
    """
    s = np.asarray(values, dtype=np.float64).copy()
    w = np.ones(graph.n, dtype=np.float64)
    for ap in send_matrices:
        s = ap @ s
        w = ap @ w
    return s / (w if s.ndim == 1 else w[:, None])


def power_iteration_norm_reference(
    graph: Graph,
    pi_rounds: int,
    ps_rounds: int,
    leader: int = 0,
    send_matrices: list[np.ndarray] | None = None,
) -> dict[str, np.ndarray]:
    """Numpy reference of the gossip ``‖v_steady‖`` estimator (`repro_torch.gossip`).

    Phase 1 (rounds ``0..pi_rounds``): power-iterate ``x ← A' x`` from
    ``x₀ = 1``.  Mass conservation keeps ``Σx = n`` while ``A'^t → v·1ᵀ``,
    so ``x → n·v`` without any explicit normalisation.

    Phase 2 (rounds ``pi_rounds..pi_rounds+ps_rounds``): push-sum average of
    the payload ``[x², 1_leader]`` → every node holds ``m2 ≈ n‖v‖²`` and
    ``z ≈ 1/n``, hence the *per-round push-sum normalisation*
    ``‖v̂‖ = √(m2·z)`` and ``n̂ = 1/z`` — all without coordination.

    ``send_matrices``, when given, supplies the per-round effective
    operators (length ``pi_rounds + ps_rounds``) of a failure draw.
    """
    n = graph.n
    if send_matrices is None:
        send_matrices = [mixing_matrix(graph)] * (pi_rounds + ps_rounds)
    if len(send_matrices) != pi_rounds + ps_rounds:
        raise ValueError(
            f"need {pi_rounds + ps_rounds} per-round operators, got {len(send_matrices)}"
        )
    x = np.ones(n, dtype=np.float64)
    for ap in send_matrices[:pi_rounds]:
        x = ap @ x
    one_hot = np.zeros(n, dtype=np.float64)
    one_hot[leader] = 1.0
    payload = np.stack([x**2, one_hot], axis=1)
    avg = push_sum_failures(graph, payload, send_matrices[pi_rounds:])
    m2, z = avg[:, 0], np.maximum(avg[:, 1], 1e-300)
    return {
        "vnorm": np.sqrt(np.maximum(m2 * z, 0.0)),
        "n_hat": 1.0 / z,
        "x": x,
        # nodes the leader's mass never visited within the budget: their
        # estimates are meaningless (the engine's gain builders fall back
        # to gain = 1 there — see repro_torch.gossip.make_gain_estimator)
        "reached": avg[:, 1] > 1e-20,
    }


def min_spread_reference(
    graph: Graph,
    values: np.ndarray,
    edge_keep: np.ndarray | None = None,
    node_active: np.ndarray | None = None,
) -> np.ndarray:
    """One round of neighbourhood min-exchange under a failure draw.

    ``out[i] = min(values[i], min over i's surviving neighbourhood)`` — the
    transport of the leaderless exponential-random-minimum size sketches
    (``repro_torch.gossip.estimate_size_leaderless`` is the engine's rendering;
    ``CommPlan.spread_min`` executes the same masks).  Failure indexing
    matches ``effective_send_matrix``: one Bernoulli per *undirected* edge
    (``Graph.edge_list()`` order) and one per node; a node always keeps its
    own values.
    """
    a = graph.adjacency.astype(bool).copy()
    if edge_keep is not None:
        edges = graph.edge_list()
        dead = np.asarray(edge_keep) == 0
        if dead.any():
            u, v = edges[dead, 0], edges[dead, 1]
            a[u, v] = False
            a[v, u] = False
    if node_active is not None:
        act = np.asarray(node_active).astype(bool)
        a = a & act[:, None] & act[None, :]
    x = np.asarray(values, dtype=np.float64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    nbr = np.where(a[:, :, None], x[None, :, :], np.inf).min(axis=1)
    out = np.minimum(x, nbr)  # self-inclusion: a node always keeps its own
    return out[:, 0] if squeeze else out


def estimate_size_sketch_reference(
    graph: Graph,
    sketches: np.ndarray,
    rounds: int,
    masks: list[tuple[np.ndarray | None, np.ndarray | None]] | None = None,
) -> np.ndarray:
    """Leaderless n̂ reference: ``rounds`` of min-exchange of the given
    (n, m) Exp(1) sketches, then the unbiased inverse-mean estimator
    ``n̂ = (m - 1) / Σ_sketches min``.  ``masks``, when given, supplies one
    (edge_keep, node_active) failure draw per round (same indexing as
    ``effective_send_matrix``)."""
    x = np.asarray(sketches, dtype=np.float64)
    if masks is None:
        masks = [(None, None)] * rounds
    if len(masks) != rounds:
        raise ValueError(f"need {rounds} per-round masks, got {len(masks)}")
    for ek, na in masks:
        x = min_spread_reference(graph, x, ek, na)
    m = x.shape[1]
    return (m - 1) / np.maximum(x.sum(axis=1), 1e-300)


def _event_weights(
    graph: Graph,
    edges_fired: np.ndarray,
    keep: np.ndarray | None,
    data_sizes: np.ndarray | None = None,
):
    """Shared prep of the event references: per-event (u, v, w_uv, w_vu).

    Weights are the synchronous receive operator's entries ``M[u, v]`` /
    ``M[v, u]`` — exactly the ``event_w`` table ``commplan.compile_plan``
    bakes for ``CommPlan.event_mix``/``event_spread``, so device-vs-
    reference parity is draw-exact given the same edge sequence (pass the
    plan's ``data_sizes`` to replay a |D_j|-weighted plan).  ``keep`` (one
    bool per event, or None = all live) replays the device's per-event
    failure draws; a padding event (edge < 0) is skipped like the device's
    zero-weight identity.
    """
    m = receive_matrix(graph, data_sizes)
    edge_list = graph.edge_list()
    fired = np.asarray(edges_fired, dtype=np.int64)
    if keep is None:
        keep = np.ones(len(fired), dtype=bool)
    keep = np.asarray(keep, dtype=bool)
    if len(keep) != len(fired):
        raise ValueError(f"need one keep flag per event, got {len(keep)} for {len(fired)}")
    for e, k in zip(fired, keep):
        if e < 0 or not k:
            continue
        u, v = int(edge_list[e, 0]), int(edge_list[e, 1])
        yield u, v, m[u, v], m[v, u]


def event_mix_reference(
    graph: Graph,
    values: np.ndarray,
    edges_fired: np.ndarray,
    keep: np.ndarray | None = None,
    data_sizes: np.ndarray | None = None,
) -> np.ndarray:
    """Replay a (time-ordered) event sequence of pairwise DecAvg exchanges:
    ``w_u ← w_u + M[u,v]·(w_v − w_u)`` and symmetrically per event — the
    numpy reference of ``CommPlan.event_mix`` scanned over an
    ``EventStream`` (``values``: (n,) or (n, k))."""
    x = np.asarray(values, dtype=np.float64).copy()
    for u, v, w_uv, w_vu in _event_weights(graph, edges_fired, keep, data_sizes):
        xu, xv = x[u].copy(), x[v].copy()
        x[u] = xu + w_uv * (xv - xu)
        x[v] = xv + w_vu * (xu - xv)
    return x


def event_spread_reference(
    graph: Graph,
    values: np.ndarray,
    edges_fired: np.ndarray,
    keep: np.ndarray | None = None,
    data_sizes: np.ndarray | None = None,
) -> np.ndarray:
    """Replay pairwise **push** events: ``s_u ← s_u − M[u,v]·s_u + M[v,u]·s_v``
    and symmetrically — mass-conserving event by event for any weights (the
    reference of ``CommPlan.event_spread``)."""
    x = np.asarray(values, dtype=np.float64).copy()
    for u, v, w_uv, w_vu in _event_weights(graph, edges_fired, keep, data_sizes):
        give_u, give_v = w_uv * x[u].copy(), w_vu * x[v].copy()
        x[u] = x[u] - give_u + give_v
        x[v] = x[v] - give_v + give_u
    return x


def event_spread_min_reference(
    graph: Graph,
    values: np.ndarray,
    edges_fired: np.ndarray,
    keep: np.ndarray | None = None,
    data_sizes: np.ndarray | None = None,
) -> np.ndarray:
    """Replay pairwise **min** events: both endpoints take the coordinate-wise
    minimum (reference of ``CommPlan.event_spread_min`` — the leaderless
    sketch transport without barriers)."""
    x = np.asarray(values, dtype=np.float64).copy()
    for u, v, _, _ in _event_weights(graph, edges_fired, keep, data_sizes):
        lo = np.minimum(x[u], x[v])
        x[u] = lo
        x[v] = lo.copy()
    return x


def push_sum_events_reference(
    graph: Graph, values: np.ndarray, edges_fired: np.ndarray, keep: np.ndarray | None = None
) -> np.ndarray:
    """Event-driven push-sum reference: spread the (s, w) pair through the
    same pairwise exchanges and return s/w — mass conservation per event
    makes the ratio converge to the uniform average with no round barrier
    (the reference of an event-driven push-sum)."""
    s = np.asarray(values, dtype=np.float64)
    squeeze = s.ndim == 1
    if squeeze:
        s = s[:, None]
    payload = np.concatenate([s, np.ones((graph.n, 1))], axis=1)
    out = event_spread_reference(graph, payload, edges_fired, keep)
    ratio = out[:, :-1] / np.maximum(out[:, -1:], 1e-300)
    return ratio[:, 0] if squeeze else ratio


def estimate_size(graph: Graph, rounds: int, leader: int = 0) -> np.ndarray:
    """Every node's estimate of n after ``rounds`` of push-sum (§4.4)."""
    one_hot = np.zeros(graph.n)
    one_hot[leader] = 1.0
    avg = push_sum(graph, one_hot, rounds)
    return 1.0 / np.maximum(avg, 1e-300)


def estimate_mean_degree(graph: Graph, rounds: int) -> np.ndarray:
    return push_sum(graph, graph.degrees.astype(np.float64), rounds)


def poll_degrees(graph: Graph, start: int, walk_length: int, n_walks: int, seed: int = 0,
                 correct_bias: bool = True) -> np.ndarray:
    """Sample degrees by random walks from ``start``.

    A simple random walk visits nodes ∝ degree (the excess-degree bias q(k),
    §3); with ``correct_bias`` we resample ∝ 1/k to recover p(k), which is the
    distribution ``v_steady_norm_from_degree_sample`` expects.

    Degree-0 guard: a walker on a neighbourless node has nowhere to go —
    ``indices[indptr[v] + 0]`` would silently read the *next* node's
    adjacency (or fall off the array for the last node).  Starting on an
    isolated node raises; walkers that reach one (possible only on directed
    graphs with out-degree-0 sinks) stay put, mirroring the on-device
    walker in ``repro_torch.gossip.walker``.
    """
    rng = np.random.default_rng(seed)
    # vectorised transition sampling: all walks advance one step per
    # iteration through the CSR neighbour lists — O(walk_length) numpy ops
    # instead of the O(n_walks · walk_length) Python loop.
    indptr, indices, _ = graph.csr()
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
    if deg[start] == 0:
        raise ValueError(
            f"poll_degrees: start node {start} has no neighbours — every walk "
            "would be stuck and the 1/k bias correction would divide by zero"
        )
    v = np.full(n_walks, start, dtype=np.int64)
    for _ in range(walk_length):
        u = rng.random(n_walks)
        alive = deg[v] > 0
        step = indptr[v] + (u * deg[v]).astype(np.int64)
        v = np.where(alive, indices[np.where(alive, step, 0)], v)
    ks = graph.degrees[v].astype(np.float64)
    if not correct_bias:
        return ks
    # importance resample ∝ 1/k to undo the stationary ∝ k visit bias.
    # Walkers trapped on a degree-0 sink carry no degree information and
    # would inject 1/0 into the weights — exclude them from the resample.
    ok = np.nonzero(ks > 0)[0]
    if len(ok) == 0:
        raise ValueError(
            "poll_degrees: every walk ended on a degree-0 sink — no degree "
            "information to resample (is the graph mostly absorbing?)"
        )
    kk = ks[ok]
    p = (1.0 / kk) / (1.0 / kk).sum()
    idx = rng.choice(len(kk), size=len(ks), p=p)
    return kk[idx]
