"""Graphs, mixing operators, initialisation, the compiled DecAvg plan and the §4.2 diffusion model."""
from . import topology
from .commplan import BACKENDS, CommPlan, FailureModel, compile_plan
from .compress import (
    Compression,
    compressed_mix,
    compressed_mix_with,
    compressed_spread,
    encode_decode,
    init_residuals,
    seed_residual,
)
from .initialisation import InitConfig, gain_from_estimates, gain_from_graph, scaled_init
from .diffusion import DiffusionResult, run_diffusion, sigma_ap_prediction
from .mixing import (
    mixing_time_estimate,
    receive_matrix,
    rewire_to_assortativity,
    spectral_gap,
    v_steady,
    v_steady_norm,
)

__all__ = [
    "BACKENDS",
    "CommPlan",
    "Compression",
    "DiffusionResult",
    "FailureModel",
    "InitConfig",
    "compile_plan",
    "compressed_mix",
    "compressed_mix_with",
    "compressed_spread",
    "encode_decode",
    "gain_from_estimates",
    "gain_from_graph",
    "init_residuals",
    "mixing_time_estimate",
    "receive_matrix",
    "rewire_to_assortativity",
    "run_diffusion",
    "scaled_init",
    "seed_residual",
    "sigma_ap_prediction",
    "spectral_gap",
    "topology",
    "v_steady",
    "v_steady_norm",
]
