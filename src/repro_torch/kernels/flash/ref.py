"""Plain PyTorch versions of flash attention (mirror ``repro/kernels/flash/ref.py``).

``attention_ref`` is the plain version: CPU tensors run it, and on the card
the kernels are held against it.  ``attention_split_ref`` renders the
Hopper kernel's tensor-core arithmetic on fp32 inputs; only the tests use it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.split import split_product

__all__ = ["attention_ref", "attention_split_ref"]


def _mask(s: int, causal: bool, window: int, device) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (j <= i)
    if window > 0:
        mask = mask & (j > i - window)
    return mask


def attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """q (B, H, S, hd); k/v (B, KVH, S, hd) → (B, H, S, hd).  fp32 scores,
    softmax and PV; the result in q's dtype.  The scores are scaled by
    ``scale`` (default 1/√hd)."""
    b, h, s, hd = q.shape
    kvh = k.shape[1]
    group = h // kvh
    qg = q.reshape(b, kvh, group, s, hd)
    scores = torch.einsum("bngsd,bntd->bngst", qg.float(), k.float())
    scores = scores / (hd**0.5) if scale is None else scores * scale
    scores = scores.masked_fill(~_mask(s, causal, window, q.device), float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,bntd->bngsd", probs, v.float())
    return out.reshape(b, h, s, hd).to(q.dtype)


def attention_split_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
    split: str = "tf32",
) -> torch.Tensor:
    """``attention_ref``'s function in the Hopper kernel's arithmetic: S = Q·Kᵀ
    as three products of hi + lo parts (``split``: "tf32" or "bf16", see
    ``split_product``), p = e^{S/√hd − max} unnormalised, P·V as three
    products with P split the same way, then out = (P·V) / Σ p.  Shapes as
    ``attention_ref``; the result in fp32."""
    b, h, s, hd = q.shape
    kvh = k.shape[1]
    qg = q.float().reshape(b, kvh, h // kvh, s, hd)
    scores = split_product("bngsd,bntd->bngst", qg, k.float(), split) / (hd**0.5)
    scores = scores.masked_fill(~_mask(s, causal, window, q.device), float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    out = split_product("bngst,bntd->bngsd", p, v.float(), split) / p.sum(dim=-1, keepdim=True)
    return out.reshape(b, h, s, hd)
