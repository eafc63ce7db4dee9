"""Public wrapper of the RWKV-6 time-mix kernel (counterpart of ``repro/kernels/rwkv/ops.py``).

The model keeps r, k, v, w as ``(..., L, H, M)``; the kernel takes
``(B, L, H, M)``.  Leading axes fold into B (a view for the model's dense
projections), so on the card nothing is copied on the way in or out.
Unlike the JAX package's wrapper it carries the recurrent state: it takes
an initial state and returns the final one beside the fp32 output.
"""
from __future__ import annotations

import torch

from .rwkv import rwkv6_chunked

__all__ = ["rwkv6_attention"]


def rwkv6_attention(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w (..., L, H, M); u (H, M); state (..., H, M, M) or None →
    (out (..., L, H, M) fp32, state (..., H, M, M) fp32)."""
    lead = r.shape[:-3]
    fold = lambda t: t.reshape(-1, *t.shape[-3:])  # noqa: E731
    s = None if state is None else state.reshape(-1, *state.shape[-3:])
    out, state = rwkv6_chunked(fold(r), fold(k), fold(v), fold(w), u, s)
    return out.reshape(*lead, *out.shape[-3:]), state.reshape(*lead, *state.shape[-3:])
