"""One flat buffer per node-stacked ensemble.

The port keeps every node-stacked parameter set (and each optimizer moment)
in ONE contiguous ``(n, d)`` fp32 tensor: row i is node i's parameters,
flattened leaf by leaf in the JAX package's leaf order (sorted keys, so
``fc0/b`` before ``fc0/w``).  The model reads its leaves as *views* into that
buffer, so one DecAvg round is one kernel launch over the whole buffer with
no concatenation and no split, and ``backward()`` writes every leaf's
gradient straight into one flat ``(n, d)`` gradient.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import torch

__all__ = ["FlatLayout", "tree_leaves", "tree_from_leaves", "tree_map"]

Tree = dict[str, Any]


def tree_map(fn, tree):
    """``fn`` applied to every leaf of nested dicts and lists (a decoder's
    ``stack`` and ``tail`` are lists of block trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Tree, prefix: tuple[str, ...] = ()) -> list[tuple[tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict in the JAX package's leaf order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += tree_leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def tree_from_leaves(paths, leaves) -> Tree:
    """The nested dict with ``leaves[i]`` at ``paths[i]``."""
    out: Tree = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Where each leaf of a per-node parameter tree sits in a flat row."""

    paths: tuple[tuple[str, ...], ...]
    shapes: tuple[tuple[int, ...], ...]  # per-node leaf shapes

    @classmethod
    def of(cls, tree: Tree) -> "FlatLayout":
        """Layout of a node-stacked tree (every leaf ``(n, ...)``)."""
        items = tree_leaves(tree)
        return cls(
            paths=tuple(p for p, _ in items),
            shapes=tuple(tuple(v.shape[1:]) for _, v in items),
        )

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(math.prod(s) for s in self.shapes)

    @property
    def size(self) -> int:
        return sum(self.sizes)

    def flatten(self, tree: Tree) -> torch.Tensor:
        """Copy a node-stacked tree into a new contiguous ``(n, d)`` buffer."""
        return torch.cat([v.reshape(v.shape[0], -1) for _, v in tree_leaves(tree)], dim=1)

    def views(self, flat: torch.Tensor) -> Tree:
        """The tree of views into ``flat`` (``(..., d)``); writes go through."""
        if flat.shape[-1] != self.size:
            raise ValueError(f"flat buffer has {flat.shape[-1]} columns, layout wants {self.size}")
        lead = flat.shape[:-1]
        ends = list(itertools.accumulate(self.sizes))
        views = [
            flat[..., end - size : end].view(*lead, *shape)
            for shape, size, end in zip(self.shapes, self.sizes, ends)
        ]
        return tree_from_leaves(self.paths, views)
