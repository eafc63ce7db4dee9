"""Mixing matrices and steady-state vectors (counterpart of ``repro/core/mixing.py``).

Conventions as in the JAX package: ``receive_matrix`` is the row-stochastic
DecAvg operator ``M`` (``w_new[i] = Σ_j M[i, j] w[j]``, and ``A[i, j] != 0``
means "i receives from j"); ``mixing_matrix`` is the column-stochastic ``A'``
of Eq. 3 whose stationary vector ``v_steady`` sets the init gain.
``spectral_gap``, ``mixing_time_estimate`` and ``rewire_to_assortativity``
(§4.4–4.5, Fig. 5) are numpy copies: the same arithmetic and the same
``default_rng`` draws, so their results are bitwise the JAX package's.
"""
from __future__ import annotations

import numpy as np

from .topology import Graph

__all__ = [
    "mixing_matrix",
    "mixing_time_estimate",
    "receive_matrix",
    "rewire_to_assortativity",
    "spectral_gap",
    "v_steady",
    "v_steady_norm",
    "v_steady_norm_closed_form",
    "v_steady_norm_from_degree_sample",
]


def _augmented(adjacency: np.ndarray, self_weights: np.ndarray | None = None) -> np.ndarray:
    """A + diag(self-weights); identity self-weights per Eq. 3 unless overridden."""
    n = adjacency.shape[0]
    if self_weights is None:
        s = np.eye(n, dtype=np.float64)
    else:
        s = np.diag(np.asarray(self_weights, dtype=np.float64))
    return adjacency.astype(np.float64) + s


def mixing_matrix(graph: Graph, self_weights: np.ndarray | None = None) -> np.ndarray:
    """Column-stochastic ``A'`` of Eq. 3 (columns sum to 1)."""
    b = _augmented(graph.adjacency, self_weights)
    col = b.sum(axis=0, keepdims=True)
    if np.any(col == 0):
        raise ValueError("graph has an isolated node with zero self-weight")
    return (b / col).astype(np.float64)


def receive_matrix(graph: Graph, data_sizes: np.ndarray | None = None) -> np.ndarray:
    """Row-stochastic DecAvg receive operator ``M`` (Eq. 2):
    ``M[i, j] = |D_j| (A_ij + I_ij) / (|D_i| + Σ_{l ∈ N_i} |D_l|)``."""
    n = graph.n
    b = graph.adjacency.astype(np.float64) + np.eye(n)
    if data_sizes is None:
        w = b
    else:
        d = np.asarray(data_sizes, dtype=np.float64)
        w = b * d[None, :]
    row = w.sum(axis=1, keepdims=True)
    return w / row


def v_steady(graph: Graph, self_weights: np.ndarray | None = None, tol: float = 1e-12, max_iter: int = 100_000) -> np.ndarray:
    """Stationary vector of ``A'`` normalised to sum 1: the closed form
    ``(k_i + 1) / Σ(k_j + 1)`` for undirected graphs with identity
    self-weights, power iteration otherwise."""
    if not graph.directed and self_weights is None:
        k = graph.degrees.astype(np.float64)
        v = k + 1.0
        return v / v.sum()
    ap = mixing_matrix(graph, self_weights)
    n = ap.shape[0]
    v = np.full(n, 1.0 / n)
    for _ in range(max_iter):
        v_next = ap @ v
        v_next /= v_next.sum()
        if np.abs(v_next - v).max() < tol:
            return v_next
        v = v_next
    raise RuntimeError("power iteration for v_steady did not converge (is the graph strongly connected?)")


def v_steady_norm(graph: Graph, self_weights: np.ndarray | None = None) -> float:
    """``‖v_steady‖_2`` — the parameter-compression factor of §4.3."""
    return float(np.linalg.norm(v_steady(graph, self_weights)))


def v_steady_norm_closed_form(degrees: np.ndarray) -> float:
    """``‖v_steady‖`` from a *full* degree sequence (undirected closed form)."""
    k1 = np.asarray(degrees, dtype=np.float64) + 1.0
    return float(np.sqrt((k1**2).sum()) / k1.sum())


def v_steady_norm_from_degree_sample(
    degree_sample: np.ndarray, n: int | float | np.ndarray
) -> float | np.ndarray:
    """Estimate ``‖v_steady‖`` from a degree sample plus an estimate of n (§4.4):
    ``‖v‖² ≈ ⟨(k+1)²⟩ / (n ⟨k+1⟩²)``, vectorised over per-node estimates."""
    k1 = np.asarray(degree_sample, dtype=np.float64) + 1.0
    out = np.sqrt(
        (k1**2).mean(axis=-1) / (np.asarray(n, np.float64) * k1.mean(axis=-1) ** 2)
    )
    return float(out) if out.ndim == 0 else out


def spectral_gap(graph: Graph, self_weights: np.ndarray | None = None) -> float:
    """1 - |λ₂| of ``A'``: the convergence rate (§4.5)."""
    eig = np.sort(np.abs(np.linalg.eigvals(mixing_matrix(graph, self_weights))))[::-1]
    return float(1.0 - eig[1])


def mixing_time_estimate(graph: Graph, eps: float = 0.25) -> float:
    """Relaxation-time bound on the ε-mixing time (§4.5):
    ``t_mix(ε) <= log(1/(ε·min_i v_i)) / gap`` for reversible chains
    (Levin & Peres, Thm 12.4)."""
    gap = spectral_gap(graph)
    v = v_steady(graph)
    return float(np.log(1.0 / (eps * v.min())) / max(gap, 1e-12))


def rewire_to_assortativity(
    graph: Graph,
    target: float,
    seed: int = 0,
    steps: int = 200_000,
    t0: float = 0.05,
    cooling: float = 0.9995,
) -> Graph:
    """Degree-preserving edge-swap annealing toward a target assortativity
    (§4.4, Fig. 5c): pick edges (a,b), (c,d), propose (a,d), (c,b), accept
    on the change of |assortativity − target| at a slowly cooled
    temperature.  Degrees, hence ``v_steady``, do not change."""
    rng = np.random.default_rng(seed)
    a = graph.adjacency.copy()
    k = a.sum(axis=1)

    # r depends on the swap only through S1 = Σ_e k_i k_j; the degree
    # moments over edge ends (each edge counted both ways) stay fixed
    ii, jj = np.nonzero(np.triu(a))
    edges = list(zip(ii.tolist(), jj.tolist()))
    m = len(edges)
    ksum = sum(k[i] + k[j] for i, j in edges)
    k2sum = sum(k[i] ** 2 + k[j] ** 2 for i, j in edges)
    mean = ksum / (2 * m)
    var = k2sum / (2 * m) - mean**2
    if var <= 0:
        return graph

    def r_of(s1: float) -> float:
        return (s1 / m - mean**2) / var

    s1 = float(sum(k[i] * k[j] for i, j in edges))
    temp = t0
    for _ in range(steps):
        e1, e2 = rng.integers(m), rng.integers(m)
        if e1 == e2:
            continue
        a1, b1 = edges[e1]
        c1, d1 = edges[e2]
        if rng.random() < 0.5:
            c1, d1 = d1, c1
        if len({a1, b1, c1, d1}) < 4:
            continue
        if a[a1, d1] or a[c1, b1]:
            continue
        s1_new = s1 - k[a1] * k[b1] - k[c1] * k[d1] + k[a1] * k[d1] + k[c1] * k[b1]
        delta = abs(r_of(s1_new) - target) - abs(r_of(s1) - target)
        if delta < 0 or rng.random() < np.exp(-delta / max(temp, 1e-9)):
            a[a1, b1] = a[b1, a1] = 0.0
            a[c1, d1] = a[d1, c1] = 0.0
            a[a1, d1] = a[d1, a1] = 1.0
            a[c1, b1] = a[b1, c1] = 1.0
            edges[e1] = (min(a1, d1), max(a1, d1))
            edges[e2] = (min(c1, b1), max(c1, b1))
            s1 = s1_new
        temp *= cooling
        if abs(r_of(s1) - target) < 5e-3 and temp < t0 / 10:
            break
    return Graph(a.astype(np.float32), name=f"{graph.name}-rho{target:g}")
