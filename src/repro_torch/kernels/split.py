"""fp32 operands on the tensor cores, rendered on the CPU: the hi + lo parts
the Hopper kernels (``flash/csrc/flash_sm90.cu``, ``rwkv/csrc/rwkv_sm90.cu``)
split an fp32 value into, and the three products they sum for one fp32
product.  Only the kernels' CPU renderings and the tests use them."""
from __future__ import annotations

import torch

__all__ = ["split_parts", "split_product"]


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 → the nearest TF32 value (10 fraction bits, ties away from zero),
    as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_parts(x: torch.Tensor, split: str) -> tuple[torch.Tensor, torch.Tensor]:
    """An fp32 operand as hi + lo in the tensor cores' input type: hi the
    nearest value of it, lo the nearest value of x − hi (exact in fp32)."""
    if split == "bf16":
        rnd = lambda t: t.bfloat16().float()  # noqa: E731
    elif split == "tf32":
        rnd = _round_tf32
    else:
        raise ValueError(f"split {split!r} is not bf16 or tf32")
    hi = rnd(x)
    return hi, rnd(x - hi)


def split_product(eq: str, a: torch.Tensor, b: torch.Tensor, split: str | None) -> torch.Tensor:
    """einsum of fp32 operands; with a split, the tensor cores' three
    products hi·hi + hi·lo + lo·hi summed in fp32 (an operand already exact
    in the input type has lo = 0, so its lo product adds nothing)."""
    if split is None:
        return torch.einsum(eq, a, b)
    (a_hi, a_lo), (b_hi, b_lo) = split_parts(a, split), split_parts(b, split)
    return torch.einsum(eq, a_hi, b_hi) + torch.einsum(eq, a_hi, b_lo) + torch.einsum(eq, a_lo, b_hi)
