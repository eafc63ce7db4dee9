"""Plain PyTorch version of flash attention (mirrors ``repro/kernels/flash/ref.py``)."""
from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """q (B, H, S, hd); k/v (B, KVH, S, hd) → (B, H, S, hd).  fp32 scores,
    softmax and PV; the result in q's dtype."""
    b, h, s, hd = q.shape
    kvh = k.shape[1]
    group = h // kvh
    qg = q.reshape(b, kvh, group, s, hd)
    scores = torch.einsum("bngsd,bntd->bngst", qg.float(), k.float())
    scores = scores / (hd**0.5)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (j <= i)
    if window > 0:
        mask = mask & (j > i - window)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,bntd->bngsd", probs, v.float())
    return out.reshape(b, h, s, hd).to(q.dtype)
