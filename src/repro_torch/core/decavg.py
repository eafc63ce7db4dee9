"""DecAvg aggregation (paper Eq. 2) as plain PyTorch (counterpart of ``repro/core/decavg.py``).

These are the plain renderings the tests hold ``CommPlan.mix`` and the
JAX package against; on the card ``CommPlan.mix`` runs the hand-written
kernels of ``repro_torch.kernels.mix`` instead.  All accumulate in fp32
regardless of the parameter dtype (the mixing weights are O(1/k) and the
post-diffusion scale is the signal bf16 accumulation would lose).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.mix.ref import decavg_mix_ref

__all__ = ["mix_array", "mix_pytree", "mix_pytree_sparse", "failure_receive_matrix"]

Tree = dict[str, Any]


def _map(fn, tree: Tree) -> Tree:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _bcast(w: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a 1-D weight vector to broadcast over ``ndim - 1`` trailing dims."""
    return w.reshape(w.shape + (1,) * (ndim - 1))


def mix_array(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x_new[i] = Σ_j m[i, j] x[j]`` over the leading node axis: the
    kernels' plain version on ``x`` flattened to (n, d)."""
    return decavg_mix_ref(m, x.reshape(x.shape[0], -1)).reshape(x.shape)


def mix_pytree(m: torch.Tensor, params: Tree) -> Tree:
    """Dense DecAvg over every leaf of a node-stacked dict."""
    return _map(lambda w: mix_array(m, w), params)


def mix_pytree_sparse(
    params: Tree,
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_w: torch.Tensor,
    self_w: torch.Tensor,
    *,
    n_nodes: int,
) -> Tree:
    """DecAvg by edge-list gather-scatter (CSR order, dst-sorted):
    ``out[i] = self_w[i]·x[i] + Σ_{e: dst[e]=i} edge_w[e]·x[src[e]]``.

    CPU only: ``index_add_`` accumulates with atomics on CUDA, whose order —
    and so whose fp32 result — changes from run to run.  The card path sums
    in the fixed tile order of the block-sparse kernel instead.
    """

    def mix_leaf(x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cpu":
            raise ValueError("mix_pytree_sparse is the CPU reference; on CUDA use CommPlan.mix")
        contrib = _bcast(edge_w, x.ndim) * x.index_select(0, src).to(torch.float32)
        agg = torch.zeros((n_nodes, *x.shape[1:]), dtype=torch.float32).index_add_(0, dst, contrib)
        out = _bcast(self_w, x.ndim) * x.to(torch.float32) + agg
        return out.to(x.dtype)

    return _map(mix_leaf, params)


def failure_receive_matrix(
    adjacency: torch.Tensor, data_sizes: torch.Tensor | None = None
) -> torch.Tensor:
    """Row-stochastic receive operator for a (possibly masked) adjacency —
    ``core.mixing.receive_matrix`` on the device, in fp32."""
    n = adjacency.shape[0]
    b = adjacency.to(torch.float32) + torch.eye(n, dtype=torch.float32, device=adjacency.device)
    if data_sizes is not None:
        b = b * data_sizes[None, :].to(torch.float32)
    return b / b.sum(dim=1, keepdim=True)
