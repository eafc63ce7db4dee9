"""One flat buffer per node-stacked ensemble.

The port keeps every node-stacked parameter set (and each optimizer moment)
in ONE contiguous ``(n, d)`` tensor: row i is node i's parameters,
flattened leaf by leaf in the JAX package's pytree order (dict keys sorted,
so ``fc0/b`` before ``fc0/w``; list and tuple items by index, as a
decoder's ``stack`` and ``tail``), so a row is ``ravel_pytree`` of the JAX
node's tree.  The model reads its leaves as *views* into that
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

__all__ = ["FlatLayout", "tree_leaves", "tree_map", "tree_structure", "tree_unflatten"]

Tree = dict[str, Any]


def tree_map(fn, tree):
    """``fn`` applied to every leaf of nested dicts and lists (a decoder's
    ``stack`` and ``tail`` are lists of block trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _children(tree) -> list | None:
    """(key, child) pairs in the JAX pytree order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_leaves(tree: Tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs of nested dicts, lists and tuples in the JAX
    package's leaf order; a path holds dict keys and list indices."""
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    out = []
    for k, v in children:
        out += tree_leaves(v, prefix + (k,))
    return out


def tree_structure(tree: Tree) -> tuple | None:
    """The tree's shape without its leaves, hashable: ``(kind, ((key, sub),
    ...))`` with kind ``"dict"``, ``"list"`` or ``"tuple"`` and the keys of
    ``_children`` (dict keys, list indices); None for a leaf."""
    children = _children(tree)
    if children is None:
        return None
    kind = "dict" if isinstance(tree, dict) else type(tree).__name__
    return (kind, tuple((k, tree_structure(v)) for k, v in children))


def tree_unflatten(structure: tuple | None, leaves) -> Any:
    """The tree of ``structure`` with ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return next(it)
        kind, items = node
        if kind == "dict":
            return {k: build(sub) for k, sub in items}
        built = [build(sub) for _, sub in items]
        return built if kind == "list" else tuple(built)

    return build(structure)


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Where each leaf of a per-node parameter tree sits in a flat row."""

    shapes: tuple[tuple[int, ...], ...]  # per-node leaf shapes
    structure: tuple | None  # ``tree_structure`` of the tree

    @classmethod
    def of(cls, tree: Tree) -> "FlatLayout":
        """Layout of a node-stacked tree (every leaf ``(n, ...)``)."""
        return cls(
            shapes=tuple(tuple(v.shape[1:]) for _, v in tree_leaves(tree)),
            structure=tree_structure(tree),
        )

    @property
    def paths(self) -> tuple[tuple, ...]:
        """Each leaf's path (dict keys and list indices), in row order."""
        return tuple(p for p, _ in tree_leaves(self.unflatten(range(len(self.shapes)))))

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
        return self.unflatten(views)

    def unflatten(self, leaves) -> Tree:
        """The tree with ``leaves`` (one per leaf, in row order) in place."""
        return tree_unflatten(self.structure, leaves)
