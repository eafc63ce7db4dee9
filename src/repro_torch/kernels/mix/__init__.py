"""DecAvg mixing kernels: dense (``mix.py``) and block-sparse (``sparse.py``),
CUDA sources in ``csrc/``, plain versions beside each wrapper."""
from .mix import mix_matmul
from .ops import decavg_mix, mix_flat
from .ref import decavg_mix_ref
from .sparse import BSR, bsr_from_dense, bsr_slots, mix_bsr, mix_bsr_ref

__all__ = [
    "BSR",
    "bsr_from_dense",
    "bsr_slots",
    "decavg_mix",
    "decavg_mix_ref",
    "mix_bsr",
    "mix_bsr_ref",
    "mix_flat",
    "mix_matmul",
]
