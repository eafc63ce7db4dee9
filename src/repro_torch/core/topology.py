"""Communication-network topologies (counterpart of ``repro/core/topology.py``).

A numpy copy of the JAX package's graph constructors: for the same arguments and
seed every constructor returns a bit-identical adjacency matrix, edge list and CSR
view.  The copy exists because the JAX package's ``core`` imports jax.
Event streams, churn sequences and edge colouring are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "Graph",
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
]


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
