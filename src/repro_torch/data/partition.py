"""Partitioning the global dataset across nodes (counterpart of ``repro/data/partition.py``).

Numpy copy, bit-identical to the JAX package for the same seed.  The
non-iid Zipf split is not ported yet.
"""
from __future__ import annotations

import numpy as np

from .synthetic import ImageDataset

__all__ = ["partition_iid", "node_datasets"]


def partition_iid(n_samples: int, n_nodes: int, seed: int = 0) -> list[np.ndarray]:
    """Disjoint uniform split: every node gets n_samples // n_nodes indices."""
    rng = np.random.default_rng(seed)
    per = n_samples // n_nodes
    perm = rng.permutation(n_samples)[: per * n_nodes]
    return [perm[i * per : (i + 1) * per].astype(np.int64) for i in range(n_nodes)]


def node_datasets(ds: ImageDataset, parts: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-node partitions into (n_nodes, per_node, ...) arrays,
    truncated to the smallest partition so the stack is rectangular."""
    per = min(len(p) for p in parts)
    xs = np.stack([ds.x[p[:per]] for p in parts])
    ys = np.stack([ds.y[p[:per]] for p in parts])
    return xs, ys
