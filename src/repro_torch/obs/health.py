"""Gossip-health channels (counterpart of ``repro/obs/health.py``) riding ``gossip.diagnostics``.

Four measurements, all JSON-able:

* :func:`consensus_distance`: mean per-node L2 distance to the fleet
  average, the quantity whose contraction the spectral gap predicts;
* :func:`mass_drift_trace`: per-round |Σs − Σs₀| / Σs₀ of a spread payload.
  ``spread`` is column-stochastic, so any drift is fp32 error: the canary
  for a broken mask or renormalisation path;
* :func:`staleness_histogram`: the event executor's linear staleness
  buckets as lists;
* :func:`gossip_health`: the convergence report's fitted against predicted
  contraction with the measured mass drift.

Every spread round is one launch of the mixing kernel over Mᵀ on the card
(``CommPlan.spread``).  Under an active failure model round r draws from
``gossip.engine.round_generator(seed, r)``, the engine's convention.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.commplan import PlanSchedule
from repro_torch.flat import tree_leaves
from repro_torch.gossip.diagnostics import convergence_report
from repro_torch.gossip.engine import round_generator

__all__ = [
    "consensus_distance",
    "gossip_health",
    "mass_drift_trace",
    "staleness_histogram",
]


def consensus_distance(params) -> torch.Tensor:
    """Mean over nodes of ‖wᵢ − w̄‖₂ across the whole flattened model, a
    float32 scalar.  ``params`` is a node-stacked tree (every leaf ``(n,
    ...)``) or the flat ``(n, d)`` buffer."""
    leaves = [v for _, v in tree_leaves(params)]
    n = leaves[0].shape[0]
    sq = torch.zeros((n,), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        flat = torch.as_tensor(leaf).reshape(n, -1).to(torch.float32)
        dev = flat - flat.mean(dim=0, keepdim=True)
        sq = sq + (dev * dev).sum(dim=1)
    return torch.sqrt(sq).mean()


def mass_drift_trace(plan, rounds: int, seed: int | None = None) -> np.ndarray:
    """(rounds + 1,) relative total-mass drift of a unit payload under
    ``plan.spread``: zero in exact arithmetic, so the curve measures fp32
    conservation through the masked operators.  ``seed`` keys the failure
    draws when the plan's failure model is active."""
    scheduled = isinstance(plan, PlanSchedule)
    if plan.failures.active and seed is None:
        raise ValueError("failure model active: mass_drift_trace needs a seed")
    x = torch.ones(plan.n, dtype=torch.float32, device=plan.device)
    sums = []
    for r in range(rounds):
        view = plan.select(r) if scheduled else plan
        gen = round_generator(seed, r) if plan.failures.active else None
        x = view.spread(x, gen)
        sums.append(x.sum())
    total0 = float(plan.n)
    got = torch.stack(sums).cpu().tolist() if sums else []
    return np.asarray([0.0] + [abs(s - total0) / total0 for s in got], dtype=np.float64)


def staleness_histogram(counts, horizon: float) -> dict:
    """The event executor's staleness buckets → ``{counts, edges}`` lists:
    linear buckets over [0, horizon], the last one catching everything
    beyond; ``edges`` the n + 1 boundaries in units of virtual time."""
    if isinstance(counts, torch.Tensor):
        counts = counts.cpu().numpy()
    c = np.asarray(counts, dtype=np.float64)
    edges = np.linspace(0.0, float(horizon), len(c) + 1)
    return {"counts": [float(v) for v in c], "edges": [float(e) for e in edges]}


def gossip_health(plan, rounds: int, seed: int | None = None, *, leader: int = 0) -> dict:
    """Measured gossip health of one plan: fitted against predicted
    contraction, rounds to 1%, and push-sum mass conservation."""
    rep = convergence_report(plan, rounds, seed, leader=leader)
    drift = mass_drift_trace(plan, rounds, seed)
    return {
        "fitted_rate": float(rep["fitted_rate"]),
        "predicted_rate": float(rep["predicted_rate"]),
        "rounds_to_1pct": int(rep["rounds_to_1pct"]),
        "max_rel_err": [float(v) for v in rep["max_rel_err"]],
        "mass_drift_max": float(drift.max()),
        "mass_drift": [float(v) for v in drift],
    }
