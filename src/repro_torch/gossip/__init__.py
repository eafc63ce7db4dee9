"""Gossip estimation for the uncoordinated init (counterpart of ``repro/gossip``).

Push-sum, the power-iteration centrality estimator, leaderless size
sketches and random-walk degree polls, run over the same ``CommPlan`` and
the same per-round failure draws as DecAvg training: every node derives
its own gain ``‖v̂_steady‖⁻¹`` from traffic on its own links.  Host numpy
reference: ``repro_torch.core.gossip``; estimate → init → train:
``repro_torch.fed.run_warmup_trajectory``.  The event-driven estimators
(``spread_events``, ``push_sum_events``,
``estimate_size_leaderless_events``) run the same protocols barrier-free,
one pairwise exchange each time an edge's Poisson clock fires.
"""
from .diagnostics import (
    convergence_report,
    fit_contraction_rate,
    predicted_contraction_rate,
    relative_error_trace,
    size_error_trace,
)
from .engine import (
    GossipEstimates,
    as_plan,
    estimate_all,
    estimate_mean_degree,
    estimate_size,
    estimate_size_leaderless,
    estimate_size_leaderless_events,
    gain_from_degree_sample,
    gains_from_estimates,
    make_gain_estimator,
    power_iteration_norm,
    push_sum,
    push_sum_events,
    round_generator,
    split_seed,
    spread_events,
    spread_rounds,
)
from .walker import poll_degrees_device

__all__ = [
    "GossipEstimates",
    "as_plan",
    "convergence_report",
    "estimate_all",
    "estimate_mean_degree",
    "estimate_size",
    "estimate_size_leaderless",
    "estimate_size_leaderless_events",
    "fit_contraction_rate",
    "gain_from_degree_sample",
    "gains_from_estimates",
    "make_gain_estimator",
    "poll_degrees_device",
    "power_iteration_norm",
    "predicted_contraction_rate",
    "push_sum",
    "push_sum_events",
    "relative_error_trace",
    "round_generator",
    "size_error_trace",
    "split_seed",
    "spread_events",
    "spread_rounds",
]
