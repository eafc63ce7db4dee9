"""Plain PyTorch oracle of the DecAvg mixing kernel (counterpart of ``repro/kernels/mix/ref.py``)."""
from __future__ import annotations

import torch

__all__ = ["decavg_mix_ref"]


def decavg_mix_ref(m: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Y = M @ W with fp32 accumulation, cast back to w.dtype."""
    return torch.matmul(m.to(torch.float32), w.to(torch.float32)).to(w.dtype)
