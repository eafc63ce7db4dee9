"""Graphs, mixing operators, initialisation and the compiled DecAvg plan."""
from . import topology
from .commplan import BACKENDS, CommPlan, FailureModel, compile_plan
from .compress import (
    Compression,
    compressed_mix,
    compressed_mix_with,
    encode_decode,
    init_residuals,
    seed_residual,
)
from .initialisation import InitConfig, gain_from_estimates, gain_from_graph, scaled_init
from .mixing import receive_matrix, v_steady, v_steady_norm

__all__ = [
    "BACKENDS",
    "CommPlan",
    "Compression",
    "FailureModel",
    "InitConfig",
    "compile_plan",
    "compressed_mix",
    "compressed_mix_with",
    "encode_decode",
    "gain_from_estimates",
    "gain_from_graph",
    "init_residuals",
    "receive_matrix",
    "scaled_init",
    "seed_residual",
    "topology",
    "v_steady",
    "v_steady_norm",
]
