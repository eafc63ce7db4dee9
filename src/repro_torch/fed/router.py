"""Consensus-aware query routing for live DFL serving (counterpart of ``repro/fed/router.py``).

Decentralised training never produces one converged artifact: each node
holds its own parameters, equal only up to the consensus noise floor.
Serving therefore means queries hit *nodes*, and the router decides which
node's parameters answer each query by trading

* **staleness** — time since the candidate last mixed (its virtual clock),
* **locality** — hop distance from the query's home node to the candidate,
* **queueing** — how far in the future the candidate's serve slot is under
  the open-loop latency model.

``QueryStream`` realises an open-loop Poisson arrival process on the host
with the padded, sorted, static-envelope discipline of
``core.topology.EventStream``, so that gossip and query events merge into
one envelope (``fed.serve.run_serve_trajectory``).  The stream and the hop
table are numpy copies of the JAX package's, bitwise for the same seed.

Routing runs on the host, where the event executor keeps the virtual
clocks: ``Router.route`` takes numpy float32 staleness and wait vectors and
computes the consensus score in float32, the JAX package's arithmetic, with
ties to the first index as ``jnp.argmin``.  A ``uniform`` router's node for
query ordinal qn is row qn of ``uniform_draws`` (numpy, from a child of the
event executor's seed): the JAX package's threefry draws cannot be
replayed, and the one hook lets a test inject them.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.topology import Graph

__all__ = [
    "QueryStream",
    "poisson_query_stream",
    "hop_matrix",
    "Router",
    "make_router",
    "uniform_draws",
    "ROUTER_POLICIES",
]

ROUTER_POLICIES = ("uniform", "local", "consensus")


@dataclasses.dataclass(frozen=True)
class QueryStream:
    """A realised open-loop query arrival schedule: sorted (time, home) events.

    ``times``  (Q,) float32 non-decreasing; padding entries hold ``horizon``.
    ``homes``  (Q,) int32 arrival node per query; padding is -1 (identity).
    ``qidx``   (Q,) int32 index into the caller's query payload pool.
    """

    times: np.ndarray
    homes: np.ndarray
    qidx: np.ndarray
    n_queries: int
    horizon: float
    qps: float

    def __post_init__(self):
        if self.times.shape != self.homes.shape or self.times.ndim != 1:
            raise ValueError(
                f"times/homes must be matching 1-D arrays, got {self.times.shape} vs {self.homes.shape}"
            )
        if self.qidx.shape != self.times.shape:
            raise ValueError("qidx must match the envelope")
        if self.n_queries > len(self.times):
            raise ValueError("n_queries exceeds the padded envelope")

    @property
    def envelope(self) -> int:
        return len(self.times)


def poisson_query_stream(
    n_nodes: int,
    horizon: float,
    qps: float,
    seed: int = 0,
    pool: int = 1,
    envelope: int | None = None,
    skew: float = 0.0,
) -> QueryStream:
    """Sample a Poisson(qps · horizon) open-loop arrival process.

    Arrival instants are iid Uniform(0, horizon), sorted; each query lands on
    a home node drawn uniformly or, with ``skew`` > 0, rank-weighted
    ∝ (rank+1)^-skew.  ``qidx`` indexes a payload pool of size ``pool``.
    Pure function of ``seed`` (``numpy.random.RandomState``).
    """
    if horizon <= 0:
        raise ValueError(f"horizon must be positive, got {horizon}")
    if qps < 0:
        raise ValueError(f"qps must be non-negative, got {qps}")
    rs = np.random.RandomState(seed)
    q = int(rs.poisson(qps * horizon)) if qps > 0 else 0
    times = np.sort(rs.uniform(0.0, horizon, size=q)).astype(np.float32)
    if skew > 0:
        w = (np.arange(n_nodes) + 1.0) ** (-float(skew))
        homes = rs.choice(n_nodes, size=q, p=w / w.sum()).astype(np.int32)
    else:
        homes = rs.randint(0, n_nodes, size=q).astype(np.int32)
    qidx = rs.randint(0, max(pool, 1), size=q).astype(np.int32)
    env = q if envelope is None else int(envelope)
    if env < q:
        raise ValueError(f"envelope {env} cannot hold {q} realised queries")
    pad = env - q
    if pad:
        times = np.concatenate([times, np.full(pad, horizon, np.float32)])
        homes = np.concatenate([homes, np.full(pad, -1, np.int32)])
        qidx = np.concatenate([qidx, np.zeros(pad, np.int32)])
    return QueryStream(times=times, homes=homes, qidx=qidx, n_queries=q, horizon=float(horizon), qps=float(qps))


def hop_matrix(graph: Graph) -> np.ndarray:
    """All-pairs hop distances (n, n) int32 by BFS frontier expansion.
    Unreachable pairs get ``n``, worse than any real path."""
    a = graph.adjacency > 0
    if graph.directed:
        a = a | a.T
    n = graph.n
    hops = np.full((n, n), n, np.int32)
    np.fill_diagonal(hops, 0)
    reach = np.eye(n, dtype=bool)
    for d in range(1, n):
        nxt = (reach @ a) & ~reach
        if not nxt.any():
            break
        hops[nxt] = d
        reach |= nxt
    return hops


def uniform_draws(n: int, seed: int, count: int) -> np.ndarray:
    """(count,) int32: the node a ``uniform`` router sends query ordinal qn
    to is row qn, drawn uniformly from [0, n) by
    ``numpy.random.default_rng(seed)`` in one call (a longer ``count``
    leaves the first rows as they were)."""
    return np.random.default_rng(int(seed)).integers(0, n, size=int(count), dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class Router:
    """Routing policy over a fixed topology.

    ``policy``: "uniform" (any node, from the draws), "local" (always the
    home node), or "consensus" (argmin of a freshness / locality / queue
    score with a hard staleness budget: candidates over budget are masked
    out unless *every* node is over budget, and then the unmasked score
    decides).
    """

    policy: str
    hops: np.ndarray  # (n, n) float32 hop distances
    staleness_budget: float = float("inf")
    locality_weight: float = 0.1
    queue_weight: float = 1.0

    @property
    def n(self) -> int:
        return self.hops.shape[0]

    def route(self, home: int, staleness: np.ndarray, wait: np.ndarray, draw: int | None = None) -> int:
        """The serving node of one query.

        ``home`` its home node, ``staleness`` (n,) float32 = t − clocks,
        ``wait`` (n,) float32 = max(busy − t, 0); ``draw`` the query's row of
        ``uniform_draws`` (a ``uniform`` router's node).  Deterministic in
        its inputs.
        """
        if self.policy == "local":
            return int(home)
        if self.policy == "uniform":
            if draw is None:
                raise ValueError("a uniform router needs the query's draw")
            return int(draw)
        if self.policy != "consensus":
            raise ValueError(f"unknown router policy {self.policy!r}")
        f32 = np.float32
        staleness = np.asarray(staleness, f32)
        score = f32(self.locality_weight) * self.hops[home] + staleness + f32(self.queue_weight) * np.asarray(wait, f32)
        ok = staleness <= f32(self.staleness_budget)
        if ok.any():
            return int(np.argmin(np.where(ok, score, f32(np.inf))))
        return int(np.argmin(score))


def make_router(
    graph: Graph,
    policy: str = "consensus",
    *,
    staleness_budget: float = float("inf"),
    locality_weight: float = 0.1,
    queue_weight: float = 1.0,
) -> Router:
    """A ``Router`` for ``graph`` (its hop table computed once, on the host)."""
    if policy not in ROUTER_POLICIES:
        raise ValueError(f"policy must be one of {ROUTER_POLICIES}, got {policy!r}")
    return Router(
        policy=policy,
        hops=hop_matrix(graph).astype(np.float32),
        staleness_budget=float(staleness_budget),
        locality_weight=float(locality_weight),
        queue_weight=float(queue_weight),
    )
