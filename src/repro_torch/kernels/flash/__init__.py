"""Flash attention: the CUDA kernel (``csrc/flash_sm90.cu``, bf16 and fp32 at
hd 32 / 64 / 128 / 160 / 256) behind ``flash_mha``, its (…, S, H, hd) wrapper
``flash_attention`` and the plain ``attention_ref``."""
from .flash import HEAD_DIMS, ROUTES, flash_mha, route
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["HEAD_DIMS", "ROUTES", "attention_ref", "flash_attention", "flash_mha", "route"]
