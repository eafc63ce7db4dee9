"""Launch plumbing shared by every kernel wrapper of the port: pointers and
streams as ctypes arguments, the dtype codes the C entry points take, and
the check of the ``cudaError_t`` a launch returns, and the refusal of a
call autograd would record (no kernel has a backward)."""
from __future__ import annotations

import ctypes

import torch

__all__ = ["DTYPE_CODES", "aligned16", "no_backward", "ptr", "raise_on_error", "stream_of"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def aligned16(t: torch.Tensor) -> bool:
    """The last axis is contiguous and every row over the leading axes starts
    on a 16-byte boundary (what TMA and 16-byte cp.async copies need)."""
    size = t.element_size()
    return (
        t.stride(-1) == 1
        and t.data_ptr() % 16 == 0
        and all((t.stride(i) * size) % 16 == 0 for i in range(t.ndim - 1))
    )


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def no_backward(name: str, *tensors) -> None:
    """Raise if autograd would record a kernel call on ``tensors``: the
    kernels write their outputs through ctypes, so a recorded call would
    return a tensor with no gradient path to its inputs."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires grad with grad mode on; "
            "train through the model's plain rendering (attention_forward does so when autograd records) "
            "or call the kernel under torch.no_grad()"
        )
