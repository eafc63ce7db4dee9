"""Public entries of the DecAvg mixing kernels (counterpart of ``repro/kernels/mix/ops.py``).

``mix_flat(op, w)`` is the entry ``CommPlan.mix`` uses: one flat ``(n, d)``
buffer, one kernel launch — the dense kernel for an ``(n, n)`` operator
tensor, the block-sparse kernel for a ``BSR``.  ``quant_mix_flat(op, x, h,
edges, ...)`` is its compressed counterpart, one int8 / fp8 gossip round:
with M dense one launch that reduces the scales, decodes and mixes; with a
``BSR`` the scales pass, then the block-sparse quantised mix.

``decavg_mix(m, tree)`` mixes a dict of node-stacked tensors (the JAX
wrapper's pytree form, for tests and general use): leaves are flattened per
node, concatenated per dtype, pushed through the same entry and split back.
With ``backend="sparse"`` the dense operator is lowered to BSR once per
distinct operator and cached on its bytes.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.flat import tree_leaves, tree_structure, tree_unflatten

from .mix import mix_matmul
from .quant import quant_mix_bsr, quant_mix_dense, quant_scales, table_bounds
from .sparse import BSR, bsr_from_dense, mix_bsr

__all__ = ["decavg_mix", "mix_flat", "per_dtype", "quant_mix_flat"]

_BSR_CACHE: dict[tuple[bytes, int, str], BSR] = {}


def _bsr_of(m: torch.Tensor, block_n: int) -> BSR:
    m_np = m.detach().to("cpu", torch.float32).numpy()
    key = (m_np.tobytes(), block_n, str(m.device))
    if key not in _BSR_CACHE:
        bc, tiles, counts = bsr_from_dense(m_np, block_n)
        _BSR_CACHE[key] = BSR(*(torch.as_tensor(a, device=m.device) for a in (bc, tiles, counts)))
        if len(_BSR_CACHE) > 64:  # bound the static-operator cache
            _BSR_CACHE.pop(next(iter(_BSR_CACHE)))
    return _BSR_CACHE[key]


def mix_flat(op: torch.Tensor | BSR, w: torch.Tensor, n_rows: int | None = None) -> torch.Tensor:
    """``w_new[i] = Σ_j M[i, j] w[j]`` over one flat (n, d) buffer.  A row
    block of M gives ``n_rows`` rows: a dense (n_rows, n) operator, or a
    ``BSR`` whose row blocks cover ``n_rows`` (omitted: n)."""
    if isinstance(op, BSR):
        return mix_bsr(op.block_cols, op.tiles, op.counts, w, n_rows)
    return mix_matmul(op, w)


def quant_mix_flat(
    op: torch.Tensor | BSR,
    x: torch.Tensor,
    h: torch.Tensor,
    edges: tuple[int, ...],
    *,
    codec: str,
    gamma: float,
    error_feedback: bool = True,
    keep: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One compressed round over one flat (n, d) buffer and its fp32 mirror
    ``h``: returns (x', h') with h' = h + Q(x − h) (Q(x) without error
    feedback) and x' = x + γ (M h' − h').  ``edges`` is the chunk table as
    host ints (``quant.table_bounds`` keeps its device copy); rows where
    ``keep`` is False keep h."""
    h_in = h if (error_feedback or keep is not None) else None
    kw = dict(codec=codec, gamma=gamma, error_feedback=error_feedback, keep=keep)
    if isinstance(op, BSR):
        bounds = table_bounds(tuple(edges), x.device)
        scales = quant_scales(x, h_in, bounds, codec=codec, error_feedback=error_feedback)
        return quant_mix_bsr(op.block_cols, op.tiles, op.counts, x, h_in, bounds, scales, **kw)
    out, _ = quant_mix_dense(op, x, h_in, edges, **kw)
    return out


def per_dtype(fn, tree: dict[str, Any]) -> dict[str, Any]:
    """``fn`` over a node-stacked dict packed as ``decavg_mix`` packs it:
    leaves flattened per node and concatenated per dtype, one ``(n, d)``
    call of ``fn`` a dtype, split back to the leaves' shapes and dtypes."""
    leaves = [v for _, v in tree_leaves(tree)]
    n = leaves[0].shape[0]
    out_leaves: list[torch.Tensor | None] = [None] * len(leaves)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for idx, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(idx)
    for idxs in by_dtype.values():
        mixed = fn(torch.cat([leaves[i].reshape(n, -1) for i in idxs], dim=1).contiguous())
        off = 0
        for i in idxs:
            size = math.prod(leaves[i].shape[1:])
            out_leaves[i] = mixed[:, off : off + size].reshape(leaves[i].shape)
            off += size
    return tree_unflatten(tree_structure(tree), out_leaves)


def decavg_mix(
    m: torch.Tensor | BSR,
    tree: dict[str, Any],
    *,
    backend: str = "dense",
    block_n: int = 32,
) -> dict[str, Any]:
    """Apply M to every leaf of a node-stacked dict (leaves share the leading
    node axis); leaf dtypes are kept.  ``m`` may already be a ``BSR``."""
    if not isinstance(m, BSR):
        if backend == "sparse":
            m = _bsr_of(m, block_n)
        elif backend != "dense":
            raise ValueError(f"unknown kernel backend {backend!r}")
    return per_dtype(lambda flat: mix_flat(m, flat), tree)
