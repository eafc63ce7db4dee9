"""Public entries of the DecAvg mixing kernels (counterpart of ``repro/kernels/mix/ops.py``).

``mix_flat(op, w)`` is the entry ``CommPlan.mix`` uses: one flat ``(n, d)``
buffer, one kernel launch — the dense kernel for an ``(n, n)`` operator
tensor, the block-sparse kernel for a ``BSR``.

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

from repro_torch.flat import tree_from_leaves, tree_leaves

from .mix import mix_matmul
from .sparse import BSR, bsr_from_dense, mix_bsr

__all__ = ["decavg_mix", "mix_flat"]

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


def mix_flat(op: torch.Tensor | BSR, w: torch.Tensor) -> torch.Tensor:
    """``w_new[i] = Σ_j M[i, j] w[j]`` over one flat (n, d) buffer."""
    if isinstance(op, BSR):
        return mix_bsr(op.block_cols, op.tiles, op.counts, w)
    return mix_matmul(op, w)


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
    paths, leaves = zip(*tree_leaves(tree))
    n = leaves[0].shape[0]
    out_leaves: list[torch.Tensor | None] = [None] * len(leaves)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for idx, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(idx)
    for idxs in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(n, -1) for i in idxs], dim=1).contiguous()
        mixed = mix_flat(m, flat)
        off = 0
        for i in idxs:
            size = math.prod(leaves[i].shape[1:])
            out_leaves[i] = mixed[:, off : off + size].reshape(leaves[i].shape)
            off += size
    return tree_from_leaves(paths, out_leaves)
