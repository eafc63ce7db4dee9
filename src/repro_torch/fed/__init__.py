"""Federated training (Algorithm 1's round, the trajectory, warmup and event executors) and offline serving."""
from .executor import (
    TrajectoryConfig,
    run_event_trajectory,
    run_sweep,
    run_trajectory,
    run_warmup_sweep,
    run_warmup_trajectory,
    stack_states,
    unstack_states,
)
from .trainer import (
    DFLState,
    init_fl_state,
    make_eval_fn,
    make_round_fn,
    sigma_metrics,
    train_loop,
)
from .serve import ServeEngine, consensus_params, decode_one, generate, generate_tokenwise, prefill

__all__ = [
    "DFLState",
    "ServeEngine",
    "TrajectoryConfig",
    "consensus_params",
    "decode_one",
    "generate",
    "generate_tokenwise",
    "init_fl_state",
    "make_eval_fn",
    "make_round_fn",
    "prefill",
    "run_event_trajectory",
    "run_sweep",
    "run_trajectory",
    "run_warmup_sweep",
    "run_warmup_trajectory",
    "sigma_metrics",
    "stack_states",
    "train_loop",
    "unstack_states",
]
