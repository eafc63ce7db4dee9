"""DecAvg mixing kernels: dense (``mix.py``), block-sparse (``sparse.py``),
row-list HYB (``hyb.py``) and quantised (``quant.py``), CUDA sources in
``csrc/``, plain versions beside each wrapper."""
from .hyb import HYB, hyb_from_tables, hyb_route, mix_hyb, mix_hyb_ref
from .mix import dense_route, mix_matmul
from .ops import decavg_mix, mix_flat, quant_mix_flat
from .quant import quant_mix_bsr, quant_mix_dense, quant_mix_pair, quant_scales, quantised_mix_bsr
from .ref import chunk_bounds, decavg_mix_ref, pair_mix_ref, pallas_bounds, quantised_decavg_mix_ref
from .sparse import BSR, bsr_from_dense, bsr_slots, mix_bsr, mix_bsr_ref, mix_bsr_rows_ref

__all__ = [
    "BSR",
    "HYB",
    "bsr_from_dense",
    "bsr_slots",
    "chunk_bounds",
    "decavg_mix",
    "decavg_mix_ref",
    "dense_route",
    "hyb_from_tables",
    "hyb_route",
    "mix_bsr",
    "mix_bsr_ref",
    "mix_bsr_rows_ref",
    "mix_flat",
    "mix_hyb",
    "mix_hyb_ref",
    "mix_matmul",
    "pair_mix_ref",
    "pallas_bounds",
    "quant_mix_bsr",
    "quant_mix_dense",
    "quant_mix_flat",
    "quant_mix_pair",
    "quant_scales",
    "quantised_decavg_mix_ref",
    "quantised_mix_bsr",
]
