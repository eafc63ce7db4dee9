"""Federated training: Algorithm 1's round and the trajectory executor."""
from .executor import TrajectoryConfig, run_sweep, run_trajectory, stack_states, unstack_states
from .trainer import (
    DFLState,
    init_fl_state,
    make_eval_fn,
    make_round_fn,
    sigma_metrics,
    train_loop,
)

__all__ = [
    "DFLState",
    "TrajectoryConfig",
    "init_fl_state",
    "make_eval_fn",
    "make_round_fn",
    "run_sweep",
    "run_trajectory",
    "sigma_metrics",
    "stack_states",
    "train_loop",
    "unstack_states",
]
