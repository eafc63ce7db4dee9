"""RWKV-6 time-mix: the CUDA kernel behind ``rwkv6_chunked`` (``csrc/rwkv_sm90.cu``,
bf16 and fp32 r/k/v at head dims 32 / 64 / 128; ``route`` names its path), its
(…, L, H, M) wrapper ``rwkv6_attention`` and the plain versions
``rwkv6_chunked_ref`` (chunked) and ``rwkv6_ref`` (per-token oracle)."""
from .ops import rwkv6_attention
from .ref import rwkv6_chunked_ref, rwkv6_ref
from .rwkv import HEAD_DIMS, ROUTES, route, rwkv6_chunked

__all__ = ["HEAD_DIMS", "ROUTES", "route", "rwkv6_attention", "rwkv6_chunked", "rwkv6_chunked_ref", "rwkv6_ref"]
