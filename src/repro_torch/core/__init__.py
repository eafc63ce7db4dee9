"""Graphs and event streams, mixing operators, initialisation, the compiled DecAvg plan, time-varying schedules and the §4.2 diffusion model."""
from . import topology
from .commplan import (
    BACKENDS,
    CommPlan,
    FailureModel,
    PlanSchedule,
    RoundMap,
    compile_plan,
    compile_schedule,
    cyclic_map,
    sequence_map,
)
from .compress import (
    Compression,
    compressed_mix,
    compressed_mix_with,
    compressed_spread,
    encode_decode,
    init_residuals,
    seed_residual,
)
from .decavg import link_failure_mask, mix_pytree_circulant, mix_pytree_colored, node_failure_mask
from .initialisation import InitConfig, gain_from_estimates, gain_from_graph, scaled_init
from .diffusion import DiffusionResult, run_diffusion, sigma_ap_prediction
from .topology import EventBatches, EventStream, batch_events_by_color, churn_sequence, poisson_event_stream
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
    "EventBatches",
    "EventStream",
    "FailureModel",
    "InitConfig",
    "PlanSchedule",
    "RoundMap",
    "batch_events_by_color",
    "churn_sequence",
    "compile_plan",
    "compile_schedule",
    "compressed_mix",
    "compressed_mix_with",
    "compressed_spread",
    "cyclic_map",
    "encode_decode",
    "gain_from_estimates",
    "gain_from_graph",
    "init_residuals",
    "link_failure_mask",
    "mix_pytree_circulant",
    "mix_pytree_colored",
    "mixing_time_estimate",
    "node_failure_mask",
    "poisson_event_stream",
    "receive_matrix",
    "rewire_to_assortativity",
    "run_diffusion",
    "scaled_init",
    "seed_residual",
    "sequence_map",
    "sigma_ap_prediction",
    "spectral_gap",
    "topology",
    "v_steady",
    "v_steady_norm",
]
