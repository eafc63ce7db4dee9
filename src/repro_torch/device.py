"""The one place that turns a caller's ``device`` argument into a torch device."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for but absent —
    the port never carries on quietly on the CPU; pass ``device="cpu"`` to
    run the plain versions there.

    Also switches TF32 off for matmuls and cuDNN: DecAvg mixing must
    accumulate in full fp32 (the post-diffusion parameter scale σ·‖v‖ is the
    signal a 10-bit mantissa would truncate), and the local steps are held
    against an fp32 reference.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
