"""Convergence diagnostics of the gossip engine (counterpart of
``repro/gossip/diagnostics.py``, paper §4.5).

Push-sum error contracts asymptotically like ``|λ₂|^t``, λ₂ the
second-largest-magnitude eigenvalue of the send operator A': the rate is
keyed to the spectral gap ``1 − |λ₂|`` (``core.mixing.spectral_gap``).
These helpers turn an engine trace into per-node relative-error curves and
a fitted per-round contraction rate, so an estimation budget (rounds) can
be chosen per topology.  Over a ``PlanSchedule`` the trace follows the
dynamic graph and the predicted rate is the round-0 graph's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.commplan import CommPlan, PlanSchedule
from repro_torch.core.mixing import spectral_gap
from repro_torch.core.topology import Graph

from .engine import as_plan, push_sum

__all__ = [
    "convergence_report",
    "fit_contraction_rate",
    "predicted_contraction_rate",
    "relative_error_trace",
    "size_error_trace",
]


def relative_error_trace(trace, truth) -> np.ndarray:
    """(rounds, n[, k]) per-round estimates → per-node |est − truth| / |truth|."""
    tr = np.asarray(torch.as_tensor(trace).cpu(), dtype=np.float64)
    t = np.asarray(truth, dtype=np.float64)
    return np.abs(tr - t) / np.maximum(np.abs(t), 1e-300)


def size_error_trace(
    plan: CommPlan | PlanSchedule | Graph, rounds: int, seed: int | None = None, *, leader: int = 0
) -> np.ndarray:
    """(rounds, n) relative error of every node's size estimate against the
    round: the one-hot is the slowest-mixing payload, so its curve bounds
    the degree / moment payloads of the same rounds."""
    plan = as_plan(plan)
    one_hot = torch.zeros(plan.n, dtype=torch.float32, device=plan.device)
    one_hot[leader] = 1.0
    _, tr = push_sum(plan, one_hot, rounds, seed, trace=True)
    n_hat = 1.0 / np.maximum(tr.cpu().numpy().astype(np.float64), 1e-300)
    return relative_error_trace(n_hat, float(plan.n))


def fit_contraction_rate(max_err: np.ndarray, floor: float = 1e-6) -> float:
    """Least-squares per-round contraction ρ of a max-over-nodes error curve:
    ``log err_t ~ t·log ρ`` after the first quarter and above the fp32
    noise floor (NaN with fewer than two such points)."""
    err = np.asarray(max_err, dtype=np.float64)
    t = np.arange(len(err))
    keep = (t >= len(err) // 4) & (err > floor) & np.isfinite(err)
    if keep.sum() < 2:
        return float("nan")
    return float(np.exp(np.polyfit(t[keep], np.log(err[keep]), 1)[0]))


def predicted_contraction_rate(graph: Graph) -> float:
    """``|λ₂| = 1 − spectral_gap``: the asymptotic per-round factor."""
    return 1.0 - spectral_gap(graph)


def convergence_report(
    plan: CommPlan | PlanSchedule | Graph, rounds: int, seed: int | None = None, *, leader: int = 0
) -> dict:
    """Measured against predicted convergence of the size estimator:
    ``{rel_err: (rounds, n), max_rel_err: (rounds,), fitted_rate,
    predicted_rate, rounds_to_1pct}``, the last the first round every node
    is within 1% (-1 if none is)."""
    plan = as_plan(plan)
    rel = size_error_trace(plan, rounds, seed, leader=leader)
    max_err = rel.max(axis=1)
    hit = np.nonzero(max_err < 1e-2)[0]
    return {
        "rel_err": rel,
        "max_rel_err": max_err,
        "fitted_rate": fit_contraction_rate(max_err),
        "predicted_rate": predicted_contraction_rate(plan.graph),
        "rounds_to_1pct": int(hit[0]) if len(hit) else -1,
    }
