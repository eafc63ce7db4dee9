"""Public wrapper of the flash attention kernel (counterpart of ``repro/kernels/flash/ops.py``).

The decoders keep activations ``(..., S, H, hd)``; the kernel takes
``(B, H, S, hd)``.  Leading axes fold into B and the head/sequence swap is a
strided view, so on the card no activation is copied on the way in or out.
"""
from __future__ import annotations

import torch

from .flash import flash_mha

__all__ = ["flash_attention"]


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """q (..., S, H, hd); k/v (..., S, KVH, hd) → (..., S, H, hd)."""
    lead = q.shape[:-3]
    qt = q.reshape(-1, *q.shape[-3:]).transpose(1, 2)
    kt = k.reshape(-1, *k.shape[-3:]).transpose(1, 2)
    vt = v.reshape(-1, *v.shape[-3:]).transpose(1, 2)
    out = flash_mha(qt, kt, vt, causal=causal, window=window)
    return out.transpose(1, 2).reshape(*lead, *q.shape[-3:])
