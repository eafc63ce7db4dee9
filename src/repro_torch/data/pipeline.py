"""Batching for the node ensemble (counterpart of ``repro/data/pipeline.py``).

Numpy copy, bit-identical to the JAX package for the same seed.  Two
renderings of one sample order: ``batch_index_schedule`` (the whole gather
schedule, uploaded once; the executor gathers each round's minibatches on
the device) and ``node_batch_iterator`` (the host iterator, whose k-th batch
selects exactly ``batch_index_schedule(...)[k]``).  Every epoch draws one
fresh permutation per node, drops the ``per_node mod batch_size`` remainder,
and all nodes cross epoch boundaries together.  ``token_batch_iterator``
draws language-model windows (x the tokens, y the next tokens) from the
same ``default_rng`` calls as the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["NodeBatches", "batch_index_schedule", "node_batch_iterator", "token_batch_iterator"]


@dataclasses.dataclass(frozen=True)
class NodeBatches:
    x: np.ndarray  # (n_nodes, batch, ...)
    y: np.ndarray  # (n_nodes, batch)


def _epoch_orders(rng: np.random.Generator, n_nodes: int, per_node: int) -> np.ndarray:
    """One epoch's per-node permutations, drawn in a single vectorised call."""
    base = np.tile(np.arange(per_node, dtype=np.int64), (n_nodes, 1))
    return rng.permuted(base, axis=1)


def batch_index_schedule(
    per_node: int, n_nodes: int, batch_size: int, n_batches: int, seed: int = 0
) -> np.ndarray:
    """The full gather schedule, (n_batches, n_nodes, batch_size) int32:
    ``schedule[k, i]`` are the sample indices of node i's k-th minibatch."""
    if batch_size > per_node:
        raise ValueError(f"batch_size {batch_size} > per_node {per_node}")
    rng = np.random.default_rng(seed)
    bpe = per_node // batch_size  # batches per epoch (remainder dropped)
    n_epochs = -(-n_batches // bpe)
    chunks = []
    for _ in range(n_epochs):
        orders = _epoch_orders(rng, n_nodes, per_node)
        ep = orders[:, : bpe * batch_size].reshape(n_nodes, bpe, batch_size)
        chunks.append(ep.transpose(1, 0, 2))  # (bpe, n_nodes, batch)
    return np.concatenate(chunks)[:n_batches].astype(np.int32)


def node_batch_iterator(
    xs: np.ndarray, ys: np.ndarray, batch_size: int, seed: int = 0
) -> Iterator[NodeBatches]:
    """Infinite iterator of per-node minibatches; same seed ⇒ the same
    batches as ``batch_index_schedule``, in the same order."""
    n_nodes, per_node = ys.shape[:2]
    if batch_size > per_node:
        raise ValueError(f"batch_size {batch_size} > per_node {per_node}")
    rng = np.random.default_rng(seed)
    bpe = per_node // batch_size
    node_idx = np.arange(n_nodes)[:, None]
    while True:
        orders = _epoch_orders(rng, n_nodes, per_node)
        for b in range(bpe):
            take = orders[:, b * batch_size : (b + 1) * batch_size]
            yield NodeBatches(x=xs[node_idx, take], y=ys[node_idx, take])


def token_batch_iterator(
    tokens_per_node: np.ndarray, batch_size: int, seq_len: int, seed: int = 0
) -> Iterator[NodeBatches]:
    """LM batches: x = tokens[t:t+L], y = tokens[t+1:t+L+1], per node;
    ``(n_nodes, batch_size, seq_len)`` int32 each, the window starts drawn
    uniformly from ``[0, stream_len − L − 1)`` in one call a batch."""
    n_nodes, stream_len = tokens_per_node.shape
    rng = np.random.default_rng(seed)
    max_start = stream_len - seq_len - 1
    node_idx = np.arange(n_nodes)[:, None, None]
    offsets = np.arange(seq_len)
    while True:
        starts = rng.integers(0, max_start, size=(n_nodes, batch_size))
        win = starts[:, :, None] + offsets  # (n_nodes, batch, seq_len)
        x = tokens_per_node[node_idx, win].astype(np.int32)
        y = tokens_per_node[node_idx, win + 1].astype(np.int32)
        yield NodeBatches(x=x, y=y)
