"""Graphs, mixing operators, initialisation and the compiled DecAvg plan."""
from . import topology
from .commplan import BACKENDS, CommPlan, FailureModel, compile_plan
from .initialisation import InitConfig, gain_from_estimates, gain_from_graph, scaled_init
from .mixing import receive_matrix, v_steady, v_steady_norm

__all__ = [
    "BACKENDS",
    "CommPlan",
    "FailureModel",
    "InitConfig",
    "compile_plan",
    "gain_from_estimates",
    "gain_from_graph",
    "receive_matrix",
    "scaled_init",
    "topology",
    "v_steady",
    "v_steady_norm",
]
