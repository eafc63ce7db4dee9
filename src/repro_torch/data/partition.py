"""Partitioning the global dataset across nodes (counterpart of ``repro/data/partition.py``).

Numpy copies, bit-identical to the JAX package for the same seed: the iid
split and the non-iid Zipf split of paper cfg. B (α = 1.8).
"""
from __future__ import annotations

import numpy as np

from .synthetic import ImageDataset

__all__ = ["partition_iid", "partition_zipf", "node_datasets"]


def partition_iid(n_samples: int, n_nodes: int, seed: int = 0) -> list[np.ndarray]:
    """Disjoint uniform split: every node gets n_samples // n_nodes indices."""
    rng = np.random.default_rng(seed)
    per = n_samples // n_nodes
    perm = rng.permutation(n_samples)[: per * n_nodes]
    return [perm[i * per : (i + 1) * per].astype(np.int64) for i in range(n_nodes)]


def partition_zipf(
    labels: np.ndarray, n_nodes: int, alpha: float = 1.8, items_per_node: int | None = None, seed: int = 0
) -> list[np.ndarray]:
    """Non-iid split: node i draws labels with a Zipf(α) preference over a
    node-specific class ranking.  Every node gets the same number of items
    (equal |D_i|, as §3 assumes) with skewed class proportions; a class that
    runs out is replaced by the least-depleted one."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    n_classes = int(labels.max()) + 1
    per = items_per_node if items_per_node is not None else len(labels) // n_nodes

    by_class = [list(rng.permutation(np.nonzero(labels == c)[0])) for c in range(n_classes)]
    zipf_w = np.arange(1, n_classes + 1, dtype=np.float64) ** (-alpha)
    zipf_w /= zipf_w.sum()

    out: list[np.ndarray] = []
    for _ in range(n_nodes):
        pref = rng.permutation(n_classes)  # node-specific class ranking
        w = np.empty(n_classes)
        w[pref] = zipf_w
        chosen: list[int] = []
        for c in rng.choice(n_classes, size=per, p=w):
            if not by_class[c]:
                avail = [k for k in range(n_classes) if by_class[k]]
                if not avail:
                    break
                c = max(avail, key=lambda k: len(by_class[k]))
            chosen.append(by_class[c].pop())
        out.append(np.asarray(chosen, dtype=np.int64))
    return out


def node_datasets(ds: ImageDataset, parts: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-node partitions into (n_nodes, per_node, ...) arrays,
    truncated to the smallest partition so the stack is rectangular."""
    per = min(len(p) for p in parts)
    xs = np.stack([ds.x[p[:per]] for p in parts])
    ys = np.stack([ds.y[p[:per]] for p in parts])
    return xs, ys
