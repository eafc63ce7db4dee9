"""Mixing matrices and steady-state vectors (counterpart of ``repro/core/mixing.py``).

Conventions as in the JAX package: ``receive_matrix`` is the row-stochastic
DecAvg operator ``M`` (``w_new[i] = Σ_j M[i, j] w[j]``, and ``A[i, j] != 0``
means "i receives from j"); ``mixing_matrix`` is the column-stochastic ``A'``
of Eq. 3 whose stationary vector ``v_steady`` sets the init gain.
"""
from __future__ import annotations

import numpy as np

from .topology import Graph

__all__ = [
    "mixing_matrix",
    "receive_matrix",
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
