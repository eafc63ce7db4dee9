"""Flash attention: the CUDA kernel (``csrc/flash.cu``) behind ``flash_mha``,
its (…, S, H, hd) wrapper ``flash_attention`` and the plain ``attention_ref``."""
from .flash import HEAD_DIMS, flash_mha
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["HEAD_DIMS", "attention_ref", "flash_attention", "flash_mha"]
