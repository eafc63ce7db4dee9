"""Communication-network topologies (counterpart of ``repro/core/topology.py``).

A numpy copy of the JAX package's graph constructors: for the same arguments and
seed every constructor returns a bit-identical adjacency matrix, edge list and CSR
view.  The copy exists because the JAX package's ``core`` imports jax.
``Graph.edge_coloring`` (the ``ppermute`` backend's schedule) colours
greedily in the same order, and ``churn_sequence`` draws the same
``default_rng(seed)`` stream, so both give bit-identical arrays too.  So do
the asynchronous event streams (``poisson_event_stream``, one Poisson clock
an edge) and their endpoint-disjoint batches (``batch_events_by_color``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "Graph",
    "EdgeColoring",
    "complete",
    "ring",
    "circulant",
    "random_k_regular",
    "erdos_renyi_gnp",
    "erdos_renyi_gnm",
    "barabasi_albert",
    "configuration_heavy_tail",
    "torus_lattice",
    "star",
    "from_adjacency",
    "churn_sequence",
    "EventStream",
    "EventBatches",
    "poisson_event_stream",
    "batch_events_by_color",
]


@dataclasses.dataclass(frozen=True)
class EdgeColoring:
    """A proper edge colouring as per-colour partial matchings.

    ``partners[c, i]`` is i's partner under colour c (i itself when i is
    unmatched in that colour): each colour class is an involution on the
    nodes.  ``edge_index[c, i]`` is the index of edge (i, partners[c, i]) in
    ``Graph.edge_list()`` (-1 when unmatched), so both endpoints key one
    failure draw on it.
    """

    partners: np.ndarray  # (n_colors, n) int32
    edge_index: np.ndarray  # (n_colors, n) int32, -1 where unmatched

    @property
    def n_colors(self) -> int:
        return self.partners.shape[0]


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected (or directed, if ``directed``) communication network."""

    adjacency: np.ndarray  # (n, n) float32, zero diagonal
    name: str
    directed: bool = False

    def __post_init__(self):
        a = self.adjacency
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"adjacency must be square, got {a.shape}")
        if np.any(np.diag(a) != 0):
            raise ValueError("adjacency must have a zero diagonal (self-loops are added by the mixing matrix)")
        if not self.directed and not np.allclose(a, a.T):
            raise ValueError("undirected graph must have a symmetric adjacency matrix")
        object.__setattr__(self, "_export_cache", {})

    @property
    def n(self) -> int:
        return self.adjacency.shape[0]

    @property
    def degrees(self) -> np.ndarray:
        """Weighted out-degree of each node (row sums for directed graphs)."""
        return self.adjacency.sum(axis=1)

    @property
    def n_edges(self) -> int:
        m = int(np.count_nonzero(self.adjacency))
        return m if self.directed else m // 2

    @property
    def mean_degree(self) -> float:
        return float(self.degrees.mean())

    def neighbours(self, i: int) -> np.ndarray:
        return np.nonzero(self.adjacency[i])[0]

    def is_connected(self) -> bool:
        """BFS connectivity check (weak connectivity for directed graphs)."""
        a = self.adjacency
        if self.directed:
            a = a + a.T
        n = self.n
        seen = np.zeros(n, dtype=bool)
        frontier = np.zeros(n, dtype=bool)
        frontier[0] = seen[0] = True
        while frontier.any():
            nxt = (a[frontier].sum(axis=0) > 0) & ~seen
            seen |= nxt
            frontier = nxt
        return bool(seen.all())

    def edge_list(self) -> np.ndarray:
        """(m, 2) int32 edges: i < j once each when undirected, every arc when
        directed, in row-major order of the adjacency — stable identifiers
        the failure model keys its per-edge draws on."""
        return self._cached("edge_list", self._build_edge_list)

    def csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR view of the *receive* pattern: (indptr, indices, edge_uid).

        Row i lists the in-neighbours j with A[i, j] != 0; ``edge_uid[e]``
        maps the e-th entry to its row in ``edge_list()`` so both directions
        of an undirected edge share one failure draw.
        """
        return self._cached("csr", self._build_csr)

    def edge_coloring(self) -> EdgeColoring:
        """Greedy proper edge colouring (≤ 2Δ − 1 colours, Δ or Δ + 1
        typical): edges in descending order of endpoint-degree sum (a
        stable sort), each given the lowest colour free at both ends.
        Undirected graphs only: a colour class must be a matching."""
        if self.directed:
            raise ValueError("edge colouring (ppermute scheduling) requires an undirected graph")
        return self._cached("edge_coloring", self._build_edge_coloring)

    def _cached(self, key: str, build):
        cache = self._export_cache
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def _build_edge_list(self) -> np.ndarray:
        a = self.adjacency
        if self.directed:
            i, j = np.nonzero(a)
        else:
            i, j = np.nonzero(np.triu(a, k=1))
        return np.stack([i, j], axis=1).astype(np.int32)

    def _build_csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        edges = self.edge_list()
        n = self.n
        if self.directed:
            # A[i, j] != 0 means "i receives from j": row i's CSR entries are
            # exactly row i's adjacency nonzeros
            dst, src = edges[:, 0], edges[:, 1]
            uid = np.arange(len(edges), dtype=np.int32)
        else:
            dst = np.concatenate([edges[:, 0], edges[:, 1]])
            src = np.concatenate([edges[:, 1], edges[:, 0]])
            uid = np.concatenate([np.arange(len(edges), dtype=np.int32)] * 2)
        order = np.lexsort((src, dst))
        dst, src, uid = dst[order], src[order], uid[order]
        indptr = np.zeros(n + 1, dtype=np.int32)
        np.add.at(indptr, dst + 1, 1)
        indptr = np.cumsum(indptr).astype(np.int32)
        return indptr, src.astype(np.int32), uid.astype(np.int32)

    def _build_edge_coloring(self) -> EdgeColoring:
        edges = self.edge_list()
        k = self.adjacency.astype(bool).sum(axis=1)
        order = np.argsort(-(k[edges[:, 0]] + k[edges[:, 1]]), kind="stable")
        node_colors: list[set[int]] = [set() for _ in range(self.n)]
        colors: list[list[tuple[int, int, int]]] = []
        for e in order:
            u, v = int(edges[e, 0]), int(edges[e, 1])
            c = 0
            used = node_colors[u] | node_colors[v]
            while c in used:
                c += 1
            if c == len(colors):
                colors.append([])
            colors[c].append((u, v, int(e)))
            node_colors[u].add(c)
            node_colors[v].add(c)
        partners = np.tile(np.arange(self.n, dtype=np.int32), (len(colors), 1))
        edge_index = np.full((len(colors), self.n), -1, dtype=np.int32)
        for c, cls in enumerate(colors):
            for u, v, e in cls:
                partners[c, u], partners[c, v] = v, u
                edge_index[c, u] = edge_index[c, v] = e
        return EdgeColoring(partners=partners, edge_index=edge_index)


def from_adjacency(a: np.ndarray, name: str = "custom", directed: bool = False) -> Graph:
    return Graph(np.asarray(a, dtype=np.float32), name=name, directed=directed)


def complete(n: int) -> Graph:
    a = np.ones((n, n), dtype=np.float32) - np.eye(n, dtype=np.float32)
    return Graph(a, name=f"complete-{n}")


def ring(n: int) -> Graph:
    return circulant(n, offsets=(1,), name=f"ring-{n}")


def circulant(n: int, offsets: Sequence[int], name: str | None = None) -> Graph:
    """Node i is connected to i ± s (mod n) for each offset s."""
    a = np.zeros((n, n), dtype=np.float32)
    for s in offsets:
        s = int(s) % n
        if s == 0:
            raise ValueError("offset 0 would be a self-loop")
        idx = np.arange(n)
        a[idx, (idx + s) % n] = 1.0
        a[(idx + s) % n, idx] = 1.0
    return Graph(a, name=name or f"circulant-{n}-{tuple(offsets)}")


def random_k_regular(n: int, k: int, seed: int = 0) -> Graph:
    """Random connected k-regular graph (networkx's suitable-edge sampler)."""
    import networkx as nx

    if (n * k) % 2 != 0:
        raise ValueError("n*k must be even")
    if k >= n:
        raise ValueError("k must be < n")
    for attempt in range(100):
        gnx = nx.random_regular_graph(k, n, seed=seed + 7919 * attempt)
        a = nx.to_numpy_array(gnx, dtype=np.float32)
        g = Graph(a, name=f"kreg-{n}-{k}")
        if g.is_connected():
            return g
    raise RuntimeError(f"failed to build a connected simple {k}-regular graph on {n} nodes")


def erdos_renyi_gnp(n: int, p: float, seed: int = 0, require_connected: bool = True) -> Graph:
    rng = np.random.default_rng(seed)
    for _attempt in range(2000):
        u = rng.random((n, n))
        upper = np.triu(u < p, k=1)
        a = (upper | upper.T).astype(np.float32)
        g = Graph(a, name=f"er-gnp-{n}-{p:g}")
        if not require_connected or g.is_connected():
            return g
    raise RuntimeError(f"failed to sample a connected G({n},{p}) graph")


def erdos_renyi_gnm(n: int, m: int, seed: int = 0, require_connected: bool = True) -> Graph:
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(n, k=1)
    for _attempt in range(2000):
        pick = rng.choice(len(iu), size=m, replace=False)
        a = np.zeros((n, n), dtype=np.float32)
        a[iu[pick], ju[pick]] = 1.0
        a += a.T
        g = Graph(a, name=f"er-gnm-{n}-{m}")
        if not require_connected or g.is_connected():
            return g
    raise RuntimeError(f"failed to sample a connected G({n},{m}) graph")


def barabasi_albert(n: int, m: int, seed: int = 0) -> Graph:
    """Barabási–Albert preferential attachment: each new node attaches m edges."""
    if m < 1 or m >= n:
        raise ValueError("need 1 <= m < n")
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), dtype=np.float32)
    # seed clique of m+1 nodes so early attachment targets exist
    for i in range(m + 1):
        for j in range(i + 1, m + 1):
            a[i, j] = a[j, i] = 1.0
    # repeated-nodes list implements linear preferential attachment
    targets_pool = list(np.nonzero(a)[0])
    for v in range(m + 1, n):
        chosen: set[int] = set()
        while len(chosen) < m:
            t = int(targets_pool[rng.integers(len(targets_pool))])
            if t != v:
                chosen.add(t)
        for t in chosen:
            a[v, t] = a[t, v] = 1.0
            targets_pool.extend([v, t])
    return Graph(a, name=f"ba-{n}-{m}")


def configuration_heavy_tail(
    n: int, gamma: float, k_min: int = 2, mean_degree: float | None = None, seed: int = 0
) -> Graph:
    """Configuration-model graph with p(k) ~ k^-gamma, made simple and connected."""
    import networkx as nx

    rng = np.random.default_rng(seed)
    k_max = max(int(np.sqrt(n)), k_min + 1)  # structural cutoff keeps the graph simple-able
    ks = np.arange(k_min, k_max + 1)
    pk = ks.astype(np.float64) ** (-gamma)
    pk /= pk.sum()
    deg = rng.choice(ks, size=n, p=pk)
    if mean_degree is not None:
        # resample individual nodes to nudge the mean toward the target
        for _ in range(20 * n):
            err = deg.mean() - mean_degree
            if abs(err) < 0.05:
                break
            i = rng.integers(n)
            deg[i] = max(k_min, min(k_max, deg[i] - int(np.sign(err))))
    if deg.sum() % 2 == 1:
        deg[int(rng.integers(n))] += 1
    # erased configuration model: pair stubs, then drop self-loops/multi-edges
    gnx = nx.configuration_model(deg.tolist(), seed=int(rng.integers(2**31)))
    gnx = nx.Graph(gnx)
    gnx.remove_edges_from(nx.selfloop_edges(gnx))
    a = nx.to_numpy_array(gnx, nodelist=range(n), dtype=np.float32)
    # stitch smaller components onto the giant one (one edge each)
    comps = sorted(nx.connected_components(gnx), key=len, reverse=True)
    giant = list(comps[0])
    for comp in comps[1:]:
        u = int(next(iter(comp)))
        v = int(giant[int(rng.integers(len(giant)))])
        a[u, v] = a[v, u] = 1.0
    g = Graph(a, name=f"conf-{n}-g{gamma:g}")
    if not g.is_connected():
        raise RuntimeError(f"failed to build connected heavy-tail configuration graph (n={n}, gamma={gamma})")
    return g


def torus_lattice(dims: Sequence[int]) -> Graph:
    """Lattice on a d-dimensional torus (each node has degree 2d)."""
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))
    coords = np.stack(np.unravel_index(np.arange(n), dims), axis=1)
    a = np.zeros((n, n), dtype=np.float32)
    for axis, size in enumerate(dims):
        nxt = coords.copy()
        nxt[:, axis] = (nxt[:, axis] + 1) % size
        j = np.ravel_multi_index(tuple(nxt.T), dims)
        i = np.arange(n)
        a[i, j] = 1.0
        a[j, i] = 1.0
    return Graph(a, name=f"torus-{'x'.join(map(str, dims))}")


def star(n: int) -> Graph:
    """Star graph: the topology of *centralised* federated learning."""
    a = np.zeros((n, n), dtype=np.float32)
    a[0, 1:] = 1.0
    a[1:, 0] = 1.0
    return Graph(a, name=f"star-{n}")


def churn_sequence(
    graph: Graph,
    k_plans: int,
    churn_rate: float,
    seed: int = 0,
    require_connected: bool = True,
) -> list[Graph]:
    """A seeded Markov chain of churned snapshots (edge up/down).

    Snapshot t + 1 perturbs snapshot t: every live edge drops independently
    with probability ``churn_rate`` and as many fresh edges appear uniformly
    among the absent pairs, so the edge count is kept while the wiring
    drifts.  Snapshot 0 is ``graph`` itself; ``churn_rate = 0`` or
    ``k_plans = 1`` is the static topology.  A disconnected draw is redrawn
    (up to 100 times) unless ``require_connected`` is False.  Unweighted
    undirected graphs only; the snapshots feed ``commplan.compile_schedule``.
    """
    if k_plans < 1:
        raise ValueError("churn_sequence needs k_plans >= 1")
    if not 0.0 <= churn_rate < 1.0:
        raise ValueError(f"churn_rate must be in [0, 1), got {churn_rate}")
    if graph.directed:
        raise ValueError("churn_sequence supports undirected graphs only")
    rng = np.random.default_rng(seed)
    a = graph.adjacency.copy()
    out = [graph]
    for t in range(1, k_plans):
        for _attempt in range(100):
            b = a.copy()
            iu, ju = np.nonzero(np.triu(b, k=1))
            drop = rng.random(len(iu)) < churn_rate
            b[iu[drop], ju[drop]] = 0.0
            b[ju[drop], iu[drop]] = 0.0
            cu, cv = np.nonzero(np.triu(b == 0, k=1))
            n_add = min(int(drop.sum()), len(cu))
            if n_add:
                pick = rng.choice(len(cu), size=n_add, replace=False)
                b[cu[pick], cv[pick]] = 1.0
                b[cv[pick], cu[pick]] = 1.0
            g = Graph(b.astype(np.float32), name=f"{graph.name}-churn{t}")
            if not require_connected or g.is_connected():
                break
        else:
            raise RuntimeError(
                f"churn_sequence: no connected churned snapshot found after 100 attempts "
                f"(n={graph.n}, churn_rate={churn_rate}); lower the rate or pass require_connected=False"
            )
        out.append(g)
        a = b
    return out


@dataclasses.dataclass(frozen=True)
class EventStream:
    """A realised asynchronous gossip schedule: sorted (time, edge) events.

    Every edge carries its own Poisson clock and the pair it joins exchanges
    whenever the clock fires; there is no global round barrier.  The process
    is realised on the host (seeded, deterministic):

    ``times``  (E,) float32, non-decreasing; padding entries hold ``horizon``.
    ``edges``  (E,) int32 indices into ``Graph.edge_list()``; padding is -1,
               which every event operator treats as the identity, so streams
               of different realised lengths share one envelope.
    ``n_events``  live events (≤ E).
    ``rates``  (m,) per-edge clock rates the stream was drawn from.
    """

    times: np.ndarray  # (E,) float32 sorted, padded with `horizon`
    edges: np.ndarray  # (E,) int32 edge ids, padded with -1
    n_events: int
    horizon: float
    rates: np.ndarray  # (m,) float64

    def __post_init__(self):
        if self.times.shape != self.edges.shape or self.times.ndim != 1:
            raise ValueError(
                f"times/edges must be matching 1-D arrays, got {self.times.shape} vs {self.edges.shape}"
            )
        if self.n_events > len(self.times):
            raise ValueError("n_events exceeds the padded envelope")

    @property
    def envelope(self) -> int:
        return len(self.times)

    @property
    def messages_per_event(self) -> int:
        """A pairwise exchange moves one model in each direction."""
        return 2


def poisson_event_stream(
    graph: Graph,
    horizon: float,
    rate: float | np.ndarray = 1.0,
    seed: int = 0,
    envelope: int | None = None,
) -> EventStream:
    """Sample per-edge Poisson clocks into a sorted, padded event stream.

    ``rate`` is a scalar (every edge), an (m,) per-edge vector in
    ``Graph.edge_list()`` order, or an (n, n) symmetric rate matrix read at
    the edge positions.  Each edge fires ``Poisson(rate_e · horizon)`` times
    at iid Uniform(0, horizon) instants; the merged stream is sorted by
    time, ties broken by edge id, so it is a function of ``seed`` alone.
    Rate 1 over ``horizon = R`` matches R synchronous rounds in expected
    per-edge traffic (fig9's budget match).  ``envelope`` pads to a fixed
    length, and raises when the realised count does not fit.
    """
    if graph.directed:
        raise ValueError("poisson_event_stream needs an undirected graph (pairwise exchanges)")
    if horizon <= 0:
        raise ValueError(f"horizon must be positive, got {horizon}")
    edges = graph.edge_list()
    m = len(edges)
    r = np.asarray(rate, dtype=np.float64)
    if r.ndim == 0:
        rates = np.full(m, float(r))
    elif r.ndim == 1:
        if r.shape[0] != m:
            raise ValueError(f"per-edge rates need shape ({m},), got {r.shape}")
        rates = r.copy()
    elif r.shape == (graph.n, graph.n):
        if not np.allclose(r, r.T):
            raise ValueError("rate matrix must be symmetric (one clock per undirected edge)")
        rates = r[edges[:, 0], edges[:, 1]].astype(np.float64)
    else:
        raise ValueError(f"rate must be scalar, ({m},) or ({graph.n}, {graph.n}), got {r.shape}")
    if np.any(rates < 0):
        raise ValueError("edge clock rates must be non-negative")
    rng = np.random.default_rng(seed)
    counts = rng.poisson(rates * horizon)
    edge_ids = np.repeat(np.arange(m, dtype=np.int32), counts)
    times = rng.uniform(0.0, horizon, size=int(counts.sum()))
    order = np.lexsort((edge_ids, times))
    times, edge_ids = times[order], edge_ids[order]
    n_events = len(times)
    width = n_events if envelope is None else int(envelope)
    if width < n_events:
        raise ValueError(
            f"envelope {width} too small for the realised stream ({n_events} events) — "
            f"size it like a Poisson tail, e.g. ceil(Σrate·T + 4·sqrt(Σrate·T))"
        )
    pad = width - n_events
    return EventStream(
        times=np.concatenate([times, np.full(pad, horizon)]).astype(np.float32),
        edges=np.concatenate([edge_ids, np.full(pad, -1, np.int32)]).astype(np.int32),
        n_events=n_events,
        horizon=float(horizon),
        rates=rates,
    )


@dataclasses.dataclass(frozen=True)
class EventBatches:
    """An ``EventStream`` regrouped into endpoint-disjoint batches.

    Consecutive events on disjoint edges commute exactly (each exchange
    touches only its two endpoints), so a run of them whose edges form a
    matching is one parallel colour step (``CommPlan.event_mix_batch``).

    ``edges``        (B, W) int32 edge ids, padded -1 (the identity);
    ``event_index``  (B, W) int32 position of each event in the original
                     stream, padded -1: an event's failure draw stays keyed
                     on it, so a batched replay draws what the sequential
                     one does.
    """

    edges: np.ndarray  # (B, W) int32, padded -1
    event_index: np.ndarray  # (B, W) int32, padded -1
    n_events: int

    @property
    def n_batches(self) -> int:
        return self.edges.shape[0]

    @property
    def width(self) -> int:
        return self.edges.shape[1]


def batch_events_by_color(stream: EventStream, graph: Graph, max_width: int | None = None) -> EventBatches:
    """Greedily batch a time-ordered ``EventStream`` into colour steps.

    Walks the live events in time order and grows the current batch until
    the next event's edge shares an endpoint with one in it (or
    ``max_width`` is reached), then starts a new one: batches keep the event
    order.  Padding events are dropped; an empty stream gives one
    all-padding batch.
    """
    edge_list = graph.edge_list()
    ids = stream.edges[: stream.n_events]
    batches: list[list[int]] = []
    indices: list[list[int]] = []
    used: set[int] = set()
    cur_e: list[int] = []
    cur_i: list[int] = []
    for pos, e in enumerate(ids):
        if e < 0:
            continue
        u, v = int(edge_list[e, 0]), int(edge_list[e, 1])
        full = max_width is not None and len(cur_e) >= max_width
        if full or u in used or v in used:
            batches.append(cur_e)
            indices.append(cur_i)
            cur_e, cur_i, used = [], [], set()
        cur_e.append(int(e))
        cur_i.append(pos)
        used.update((u, v))
    if cur_e or not batches:
        batches.append(cur_e)
        indices.append(cur_i)
    width = max(max(len(b) for b in batches), 1)
    out_e = np.full((len(batches), width), -1, np.int32)
    out_i = np.full((len(batches), width), -1, np.int32)
    for b, (es, ix) in enumerate(zip(batches, indices)):
        out_e[b, : len(es)] = es
        out_i[b, : len(ix)] = ix
    return EventBatches(edges=out_e, event_index=out_i, n_events=int((ids >= 0).sum()))
